"""LM assembly from PTC layers: decoder-only, enc-dec and VLM stacks.

Counterpart of ``repro/models/lm.py``: architectures are described by
:class:`ArchConfig` and composed as ``n_periods`` repetitions of a static
*period plan* (gemma2's local/global alternation is a period of two
attention sub-layers, jamba's a period of one attention and seven mamba
sub-layers with MoE on every other one, llama-vision's a period of five
self-attention layers whose last adds cross-attention to the image
tokens; whisper's decoder cross-attends on every layer to the output of
a separate non-causal encoder stack); per-position parameters are
stacked on a leading period axis, as the reference's ``jax.vmap`` init
gives them, and every path walks the periods in a Python loop (the
reference scans them).

Training: :func:`forward` (logits and the MoE balance loss), the
memory-lean :func:`cross_entropy` with the reference's own backward,
:func:`inject_masks` (the paper's per-step feedback / column sampling as
``fb`` / ``col`` leaves inside each PTC dict) and
:func:`build_train_step` (gradients of the trainable leaves only).
Serving: the solo serve step over a dense decode cache and the gateway's
steps, which push the reference's PTC scope names ``p{period}.s{sub}.
attn`` / ``.cross`` / ``.mamba`` / ``.mlp``.  The MoE experts run
unscoped and are never offered to the execution hook, as the
reference's run under ``vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from ..core.sparsity import SparsityConfig, column_mask, feedback_mask
from .attention import (AttnCfg, attention, decode_attention,
                        decode_attention_paged,
                        decode_attention_paged_chunked, init_attention,
                        init_kv_cache)
from .ffn import FFNCfg, MoECfg, init_mlp, init_moe, mlp, moe
from .layers import (PTCLinearCfg, combine, embed, init_embedding,
                     init_layernorm, init_rmsnorm, layernorm, layernorm_np,
                     partition, ptc_scope, rmsnorm, softcap, stacked,
                     trainable_mask, tree_map)
from .ssm import SSMCfg, init_mamba, init_ssm_state, mamba, mamba_decode

__all__ = ["ArchConfig", "SubLayerPlan", "period_plan", "init_model",
           "model_trainable_mask", "inject_masks", "forward",
           "cross_entropy", "build_train_step", "init_decode_cache",
           "build_serve_step", "build_gateway_step",
           "build_gateway_prefill_step"]

Params = dict
REMAT_POLICIES = ("full", "dots", "none")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    # attention flavour
    rope_theta: float = 10000.0
    rope_frac: float = 1.0
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None
    local_global: bool = False      # gemma2: alternate local/global layers
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1             # MoE every `moe_period`-th sub-layer
    moe_dispatch: str = "pjit"      # pjit | a2a (one device: the same path)
    # ssm / hybrid
    ssm_state: int = 0
    ssm_chunk: int = 256            # scan chunk length
    attn_period: int = 0            # jamba: 1 attn per `attn_period` layers
    # enc-dec / vlm
    n_enc_layers: int = 0
    cross_attn_period: int = 0      # cross-attn every N-th layer
    n_img_tokens: int = 0
    # norms / activations / embeddings
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam
    act: str = "silu"
    post_norm: bool = False         # gemma2 sandwich norm
    tie_embed: bool = True
    # substrate policy
    ptc: PTCLinearCfg = dataclasses.field(default_factory=PTCLinearCfg)
    remat: bool = True              # recompute each period in the backward
    remat_policy: str = "full"      # full | dots (keep the 2-D products'
    #                                 outputs) | none
    attn_chunk: int | None = None   # chunked-softmax threshold (keys)

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"{self.name}: unknown remat_policy {self.remat_policy!r} "
                f"(one of {REMAT_POLICIES})")

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def attn_cfg(self, window=None, causal=True) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                       rope_theta=self.rope_theta, rope_frac=self.rope_frac,
                       qk_norm=self.qk_norm, attn_softcap=self.attn_softcap,
                       qkv_bias=self.qkv_bias, causal=causal, window=window)

    def moe_cfg(self) -> MoECfg:
        return MoECfg(d_model=self.d_model, d_ff=self.d_ff,
                      n_experts=self.n_experts, top_k=self.top_k,
                      act=self.act, dispatch=self.moe_dispatch)

    def ffn_cfg(self) -> FFNCfg:
        return FFNCfg(d_model=self.d_model, d_ff=self.d_ff, act=self.act)

    def ssm_cfg(self) -> SSMCfg:
        return SSMCfg(d_model=self.d_model, d_state=self.ssm_state,
                      chunk=self.ssm_chunk)


@dataclasses.dataclass(frozen=True)
class SubLayerPlan:
    kind: str                       # attn | mamba
    ffn: str                        # mlp | moe | none
    window: int | None = None
    cross: bool = False             # extra cross-attention block
    causal: bool = True             # False for encoder stacks


# the encdec family's encoder: one non-causal attention + MLP sub-layer,
# stacked over n_enc_layers
ENC_PLAN = SubLayerPlan("attn", "mlp", causal=False)


def _periods(cfg: ArchConfig, length: int, what: str) -> int:
    if cfg.n_layers % length:
        raise ValueError(f"{cfg.name}: {what} needs a layer count divisible "
                         f"by {length}, got {cfg.n_layers}")
    return cfg.n_layers // length


def period_plan(cfg: ArchConfig) -> tuple[list[SubLayerPlan], int]:
    """(plan, n_periods): the static per-period sub-layer schedule."""
    ffn = "moe" if (cfg.n_experts > 0 and cfg.attn_period == 0) else "mlp"
    if cfg.family == "encdec":
        # the DECODER stack (self-attention, then cross-attention to the
        # encoder's output); the encoder is a separate stack
        return [SubLayerPlan("attn", ffn, cross=True)], cfg.n_layers
    if cfg.family == "vlm":
        # cross-attention to the image tokens on the last layer of each
        # period of `cross_attn_period` layers
        cp = cfg.cross_attn_period
        return [SubLayerPlan("attn", "mlp", cross=(i == cp - 1))
                for i in range(cp)], _periods(cfg, cp, "the vlm period")
    if cfg.family in ("dense", "moe"):
        if cfg.local_global:
            return [SubLayerPlan("attn", ffn, window=cfg.sliding_window),
                    SubLayerPlan("attn", ffn, window=None)], \
                _periods(cfg, 2, "local/global alternation")
        return [SubLayerPlan("attn", ffn)], cfg.n_layers
    if cfg.family == "ssm":
        return [SubLayerPlan("mamba", "none")], cfg.n_layers
    if cfg.family == "hybrid":
        # jamba: a period of `attn_period` layers, attention first and
        # mamba after, MoE on every `moe_period`-th position
        plan = [SubLayerPlan(
            "attn" if i == 0 else "mamba",
            "moe" if (cfg.n_experts and i % cfg.moe_period == 1) else "mlp")
            for i in range(cfg.attn_period)]
        return plan, _periods(cfg, cfg.attn_period, "the hybrid period")
    raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def _init_norm(cfg: ArchConfig, device) -> Params:
    if cfg.norm == "rmsnorm":
        return init_rmsnorm(cfg.d_model, device)
    if cfg.norm == "layernorm":
        return init_layernorm(cfg.d_model, device)
    return {}   # nonparam


def _apply_norm(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rmsnorm(p, x)
    if cfg.norm == "layernorm":
        return layernorm(p, x)
    return layernorm_np(x)


def _init_sublayer(gen: torch.Generator, cfg: ArchConfig,
                   plan: SubLayerPlan) -> Params:
    dev = gen.device
    p: Params = {"ln1": _init_norm(cfg, dev)}
    if plan.kind == "attn":
        p["attn"] = init_attention(gen, cfg.attn_cfg(plan.window), cfg.ptc)
    else:
        p["mamba"] = init_mamba(gen, cfg.ssm_cfg(), cfg.ptc)
    if cfg.post_norm:
        p["pn1"] = _init_norm(cfg, dev)
    if plan.cross:
        p["lnx"] = _init_norm(cfg, dev)
        p["cross"] = init_attention(gen, cfg.attn_cfg(causal=False), cfg.ptc)
    if plan.ffn != "none":
        p["ln2"] = _init_norm(cfg, dev)
        if plan.ffn == "moe":
            p["moe"] = init_moe(gen, cfg.moe_cfg(), cfg.ptc)
        else:
            p["mlp"] = init_mlp(gen, cfg.ffn_cfg(), cfg.ptc)
        if cfg.post_norm:
            p["pn2"] = _init_norm(cfg, dev)
    return p


def init_model(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters on the generator's device: embedding (and
    unembedding when untied) in the base dtype, fp32 norms and Σ, one
    ``pos{i}`` tree per plan position stacked over the periods, and for
    encdec the encoder stack ``enc`` (one non-causal attention + MLP
    sub-layer stacked over ``n_enc_layers``) and its ``enc_norm``."""
    plan, n_periods = period_plan(cfg)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model,
                                cfg.ptc.base_dtype),
        "final_norm": _init_norm(cfg, gen.device),
    }
    if not cfg.tie_embed:
        params["unembed"] = {"w": (torch.randn(
            (cfg.vocab, cfg.d_model), generator=gen, device=gen.device)
            * (cfg.d_model ** -0.5)).to(cfg.ptc.base_dtype)}
    for i, sub in enumerate(plan):
        params[f"pos{i}"] = stacked(lambda sub=sub: _init_sublayer(
            gen, cfg, sub), n_periods)
    if cfg.family == "encdec":
        params["enc"] = stacked(lambda: _init_sublayer(
            gen, cfg, ENC_PLAN), cfg.n_enc_layers)
        params["enc_norm"] = _init_norm(cfg, gen.device)
    return params



def model_trainable_mask(params: Params) -> Params:
    return trainable_mask(params)


# ---------------------------------------------------------------------------
# sampling-mask injection (paper §3.4.2, LM-scale)
# ---------------------------------------------------------------------------


def inject_masks(params: Params, gen: torch.Generator, scfg: SparsityConfig,
                 n_tokens: int) -> Params:
    """A copy of ``params`` with the step's ``fb`` (Q, P) feedback mask
    and ``col`` (``n_tokens``,) column mask leaves in every PTC dict (the
    reference's ``jax.random.fold_in`` per leaf becomes draws from one
    generator, PTC dicts in the reference's order).

    The masks are drawn from the detached block energies; a stacked
    leading axis (periods, experts) gets one mask per entry, so slicing
    the period hands each layer its own.  A layer that reads other than
    ``n_tokens`` rows (vlm's cross-attention K/V) then fails in
    :func:`repro_torch.core.subspace.ptc_linear`, as the reference
    does."""
    if not scfg.enabled:
        return params

    def walk(p):
        if not isinstance(p, dict):
            return p
        if not ("u" in p and "s" in p and "v" in p):
            # sorted keys: the order ``jax.tree`` walks a dict
            return {k: walk(v) for k, v in sorted(p.items())}
        out = dict(p)
        with torch.no_grad():
            energy = torch.sum(p["s"].float() ** 2, dim=-1)       # (..., P, Q)
        lead = tuple(energy.shape[:-2])
        n = math.prod(lead)
        if scfg.alpha_w < 1.0:
            e2 = energy.reshape((n,) + tuple(energy.shape[-2:]))
            fb = torch.stack([feedback_mask(gen, e, scfg) for e in e2])
            out["fb"] = fb.reshape(lead + tuple(fb.shape[1:]))
        if scfg.alpha_c < 1.0:
            col = torch.stack([column_mask(gen, n_tokens, scfg)
                               for _ in range(n)])
            out["col"] = col.reshape(lead + (n_tokens,))
        return out

    return walk(params)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def _sublayer_fwd(cfg: ArchConfig, plan: SubLayerPlan, p: Params, x,
                  positions, cross_kv=None):
    """One sub-layer of the training / prefill path: (x, aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _apply_norm(cfg, p["ln1"], x)
    if plan.kind == "attn":
        h = attention(p["attn"], cfg.attn_cfg(plan.window, plan.causal),
                      cfg.ptc, h, positions, chunk=cfg.attn_chunk)
    else:
        h = mamba(p["mamba"], cfg.ssm_cfg(), cfg.ptc, h)
    if cfg.post_norm:
        h = _apply_norm(cfg, p["pn1"], h)
    x = x + h
    if plan.cross:
        # cross-attention to the image tokens / the encoder's output: not
        # rotated (no positions), not causal
        h = _apply_norm(cfg, p["lnx"], x)
        h = attention(p["cross"], cfg.attn_cfg(causal=False), cfg.ptc, h,
                      None, kv_x=cross_kv)
        x = x + h
    if plan.ffn != "none":
        h = _apply_norm(cfg, p["ln2"], x)
        if plan.ffn == "moe":
            h, a = moe(p["moe"], cfg.moe_cfg(), cfg.ptc, h)
            aux = aux + a
        else:
            h = mlp(p["mlp"], cfg.ffn_cfg(), cfg.ptc, h)
        if cfg.post_norm:
            h = _apply_norm(cfg, p["pn2"], h)
        x = x + h
    return x, aux


# the products the reference's "dots" policy keeps
# (``dots_with_no_batch_dims_saveable``): a matmul with no batch dimension
# reaches the dispatcher as one of these, a batched one (attention's
# scores, the blocked PTC forward's plain einsums, the MoE experts) as
# ``bmm``
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """Keep the outputs of the products with no batch dimension, recompute
    everything else: never an allocation, which a CUDA kernel bound through
    ctypes fills where the dispatcher cannot see it (a kept ``empty``
    would hand the recompute a buffer its kernel never wrote)."""
    if func in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _run_stack(cfg: ArchConfig, plan, stacks: list, n_periods: int, x,
               positions, cross_kv=None):
    """Walk the ``n_periods`` periods of the stack (``stacks[i]``: plan
    position i's tree with its leading period axis): (x, the summed aux
    loss).  With ``remat`` each period runs under ``torch.utils.
    checkpoint``: the policy "full" recomputes all of it in the backward,
    "dots" keeps the outputs of its 2-D products and recomputes the rest
    (the products' outputs are the same bits, so the gradients are too)."""
    def body(x, aux, layer, cross_kv):
        for i, sub in enumerate(plan):
            x, a = _sublayer_fwd(cfg, sub, layer[i], x, positions, cross_kv)
            aux = aux + a
        return x, aux

    remat = cfg.remat and cfg.remat_policy != "none"
    kw = {"context_fn": _DOTS_CONTEXT} if cfg.remat_policy == "dots" else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pi in range(n_periods):
        layer = [tree_map(lambda a: a[pi], st) for st in stacks]
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(body, x, aux, layer, cross_kv,
                                use_reentrant=False, preserve_rng_state=False,
                                **kw)
        else:
            x, aux = body(x, aux, layer, cross_kv)
    return x, aux


def _head(cfg: ArchConfig, params: Params, x) -> torch.Tensor:
    """The final norm, the tied or untied unembedding, the soft-cap."""
    x = _apply_norm(cfg, params["final_norm"], x)
    w = params["embed"]["e"] if cfg.tie_embed else params["unembed"]["w"]
    return softcap(x @ w.T, cfg.final_softcap)


def forward(params: Params, cfg: ArchConfig, batch: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token logits (B, S, vocab) for a full sequence, and the MoE
    balance loss.  ``batch``: ``tokens`` (B, S); encdec adds ``frames``
    (B, S_enc, d), the stubbed audio frontend's output, which the encoder
    stack turns into the decoder's cross-attention input; vlm adds
    ``img`` (B, n_img, d), the stubbed vision tower's, cross-attended as
    it is."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, device=dev)[None].expand(b, s)
    x = embed(params["embed"], tokens)
    if cfg.family != "ssm":
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=dev)

    cross_kv = None
    if cfg.family == "encdec":
        enc = batch["frames"].to(x.dtype)
        enc_pos = torch.arange(enc.shape[1], device=dev)[None].expand(
            b, enc.shape[1])
        enc_out, _ = _run_stack(cfg, [ENC_PLAN], [params["enc"]],
                                cfg.n_enc_layers, enc, enc_pos)
        cross_kv = _apply_norm(cfg, params["enc_norm"], enc_out)
    if cfg.family == "vlm":
        cross_kv = batch["img"].to(x.dtype)

    plan, n_periods = period_plan(cfg)
    x, aux = _run_stack(cfg, plan, [params[f"pos{i}"]
                                    for i in range(len(plan))],
                        n_periods, x, positions, cross_kv)
    return _head(cfg, params, x), aux


class _CE(torch.autograd.Function):
    """Memory-lean softmax cross-entropy with the reference's backward:
    the (N, V) logits are never upcast (only the max and the denominators
    go to fp32), and the backward forms ``(soft − onehot) · (g / n)`` in
    the logits' dtype, ``soft`` one softmax in that dtype.  (Autograd
    through ``log_softmax`` would round a bf16 gradient elsewhere.)"""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)                      # in logits' dtype
        denom = p.sum(-1, dtype=torch.float32)
        gold = torch.take_along_dim(logits, labels[..., None], -1)[..., 0]
        lse = m[..., 0].float() + torch.log(denom)
        return torch.mean(lse - gold.float())

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        denom = p.sum(-1, keepdim=True, dtype=torch.float32)
        soft = p / denom.to(p.dtype)
        # soft − onehot: one subtraction at each row's label, rounded as
        # the reference's subtraction of the one-hot rounds it
        ones = torch.ones_like(labels[..., None], dtype=soft.dtype)
        soft.scatter_add_(-1, labels[..., None], -ones)
        return soft * (g / labels.numel()).to(soft.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy (fp32 scalar) of (..., V) logits against
    integer labels."""
    return _CE.apply(logits, labels.long())


def build_train_step(cfg: ArchConfig, sparsity: SparsityConfig | None = None):
    """Returns ``train_step(params, batch, gen) -> (loss, grads)``.

    Gradients are taken only for the trainable leaves (Σ and the
    electronics); the frozen U/V bases enter the forward as constants.
    ``grads`` has ``params``' structure with a scalar zero of the leaf's
    dtype at every frozen position.  With ``sparsity`` enabled the step's
    masks are drawn from ``gen`` (:func:`inject_masks`) over the batch's
    B·S tokens."""
    scfg = sparsity

    def train_step(params, batch, gen=None):
        mask = trainable_mask(params)
        tr, fr = partition(params, mask)
        leaves = []

        def leaf(a, m):
            if not m:
                return a
            a = a.detach().requires_grad_()
            leaves.append(a)
            return a

        tr = tree_map(leaf, tr, mask)
        p = combine(tr, fr, mask)
        if scfg is not None and scfg.enabled:
            n_tokens = batch["tokens"].shape[0] * batch["tokens"].shape[1]
            p = inject_masks(p, gen, scfg, n_tokens)
        logits, aux = forward(p, cfg, batch)
        loss = cross_entropy(logits, batch["labels"]) + aux
        got = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

        def grad(a, m):
            if not m:
                return torch.zeros((), dtype=a.dtype, device=a.device)
            g = next(got)
            return torch.zeros_like(a) if g is None else g

        return loss.detach(), tree_map(grad, params, mask)

    return train_step


# ---------------------------------------------------------------------------
# serve and gateway steps
# ---------------------------------------------------------------------------


def _build_step(cfg: ArchConfig, attend: Callable, last_column: Callable,
                collect: Callable):
    """The shared body of the serving steps: embed, walk every period's
    sub-layers on that layer's slice of the per-position ``state`` tree,
    final norm, logits.  An attention position runs ``attend(p, acfg,
    lin, h, state, batch) -> (h, new)``; a mamba position one step of the
    recurrence, ``new`` being its replacement state.
    ``last_column(logits, batch)`` picks each row's (B, vocab) logits and
    ``collect(state, outs)`` makes the returned state from the per-period
    ``new`` trees."""
    plan, n_periods = period_plan(cfg)

    @torch.no_grad()
    def step(params, state, batch):
        x = embed(params["embed"], batch["token"])
        if cfg.family != "ssm":
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        kv_x = _serve_cross_kv(cfg, batch, x.dtype)
        outs = []
        for pi in range(n_periods):
            with ptc_scope(f"p{pi}"):
                new = {}
                for i, sub in enumerate(plan):
                    name = f"pos{i}"
                    p = tree_map(lambda a: a[pi], params[name])
                    st = tree_map(lambda a: a[pi], state[name])
                    h = _apply_norm(cfg, p["ln1"], x)
                    if sub.kind == "attn":
                        with ptc_scope(f"s{i}.attn"):
                            h, new[name] = attend(
                                p["attn"], cfg.attn_cfg(sub.window), cfg.ptc,
                                h, st, batch)
                    else:
                        with ptc_scope(f"s{i}.mamba"):
                            h, new[name] = mamba_decode(
                                p["mamba"], cfg.ssm_cfg(), cfg.ptc, h, st)
                    if cfg.post_norm:
                        h = _apply_norm(cfg, p["pn1"], h)
                    x = x + h
                    if sub.cross:
                        h = _apply_norm(cfg, p["lnx"], x)
                        with ptc_scope(f"s{i}.cross"):
                            h = attention(p["cross"],
                                          cfg.attn_cfg(causal=False),
                                          cfg.ptc, h, None, kv_x=kv_x)
                        x = x + h
                    if sub.ffn == "none":
                        continue
                    h = _apply_norm(cfg, p["ln2"], x)
                    if sub.ffn == "moe":
                        h, _ = moe(p["moe"], cfg.moe_cfg(), cfg.ptc, h)
                    else:
                        with ptc_scope(f"s{i}.mlp"):
                            h = mlp(p["mlp"], cfg.ffn_cfg(), cfg.ptc, h)
                    if cfg.post_norm:
                        h = _apply_norm(cfg, p["pn2"], h)
                    x = x + h
            outs.append(new)
        return last_column(_head(cfg, params, x), batch), \
            collect(state, outs)

    return step


def _serve_cross_kv(cfg: ArchConfig, batch: dict, dtype: torch.dtype):
    """The serve step's cross-attention input, in the model's dtype: vlm's
    ``img`` (B, n_img, d), encdec's ``enc_out`` (B, S_enc, d) (the
    encoder's output; the serve step runs no encoder), else None."""
    if cfg.family == "vlm":
        return batch["img"].to(dtype)
    if cfg.family == "encdec":
        return batch["enc_out"].to(dtype)
    return None


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> Params:
    """The solo serve path's decode state, per plan position stacked on the
    period axis and zeroed: the dense KV cache ``{"k", "v"}`` of
    (n_periods, B, max_len, Hkv, Dh) in bf16 at attention positions, the
    SSM state ``{"h", "conv"}`` (``init_ssm_state``) at mamba ones."""
    plan, n_periods = period_plan(cfg)
    cache: Params = {}
    for i, sub in enumerate(plan):
        if sub.kind == "attn":
            one = init_kv_cache(batch, max_len, cfg.attn_cfg(sub.window),
                                device=device)
        else:
            one = init_ssm_state(batch, cfg.ssm_cfg(), device=device)
        cache[f"pos{i}"] = {kk: a.new_zeros((n_periods,) + tuple(a.shape))
                            for kk, a in one.items()}
    return cache


def _stack(outs: list, names) -> Params:
    """The per-period ``new`` trees of ``names`` stacked on the period
    axis."""
    return {name: tree_map(lambda *xs: torch.stack(xs),
                           *(o[name] for o in outs)) for name in names}


def build_serve_step(cfg: ArchConfig):
    """Returns ``serve_step(params, cache, batch) -> (logits, cache)``: one
    new token per row against the decode cache.

    ``batch``: {"token": (B, 1) int, "cache_len": int} — every row at the
    same position — plus ``img`` (vlm) or ``enc_out`` (encdec), whose K
    and V each cross-attention layer recomputes at every step, as the
    reference does.  Each attention layer's new K/V row is written into
    ``cache`` in place (the reference returns an updated copy); each mamba
    position's state is replaced in the returned tree.  Logits: (B,
    vocab).  PTC scope names are the gateway steps' (``p{period}.s{sub}.
    attn.wq`` ...)."""
    plan, _ = period_plan(cfg)
    recurrent = [f"pos{i}" for i, sub in enumerate(plan)
                 if sub.kind == "mamba"]

    def attend(p, acfg, lin, h, layer_cache, batch):
        return decode_attention(p, acfg, lin, h, layer_cache,
                                batch["cache_len"])

    def collect(cache, outs):
        return {**cache, **_stack(outs, recurrent)}

    return _build_step(cfg, attend, lambda logits, batch: logits[:, 0],
                       collect)


def _stack_new_kv(views, outs):
    return _stack(outs, outs[0])


def _refuse(cfg: ArchConfig) -> None:
    """The gateway steps' refusals, the reference's messages."""
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(
            f"gateway decode does not support {cfg.family} archs "
            f"(per-request cross-attention streams are not paged yet)")
    if cfg.n_experts > 0:
        raise ValueError("gateway decode does not support MoE archs yet")


def build_gateway_step(cfg: ArchConfig):
    """Returns ``gateway_step(params, views, batch) -> (logits, new_kv)``:
    the continuous-batching decode step over page-assembled KV views with
    per-slot cache lengths (``repro_torch.serving.engine``).

    ``batch``: {"token": (B, 1) int, "lens": (B,) int32}.  ``views``: per
    plan position either ``{"k", "v"}`` of (n_periods, B, S_max, Hkv, Dh)
    gathered from the page pool, or an SSM state (:func:`init_decode_
    cache`'s).  ``new_kv`` holds each attention position's NEW (n_periods,
    B, 1, Hkv, Dh) rows, which the engine scatters into the pool, and each
    mamba position's whole replacement state.  Logits: (B, vocab).  vlm,
    encdec and MoE archs are refused, as the reference refuses them."""
    _refuse(cfg)

    def attend(p, acfg, lin, h, view, batch):
        h, k_new, v_new = decode_attention_paged(p, acfg, lin, h, view["k"],
                                                 view["v"], batch["lens"])
        return h, {"k": k_new, "v": v_new}

    return _build_step(cfg, attend, lambda logits, batch: logits[:, 0],
                       _stack_new_kv)


def build_gateway_prefill_step(cfg: ArchConfig, kv_block: int | None = None):
    """Returns ``prefill_step(params, views, batch) -> (logits, new_kv)``:
    the chunked-prefill gateway step, every slot advancing up to C tokens.

    ``batch``: {"token": (B, C) int, "lens": (B,) int32, "n_valid": (B,)
    int32} — slot b's next ``n_valid[b]`` tokens sit in columns
    0..n_valid-1 at absolute positions ``lens[b] + c`` (decode slots ride
    along with n_valid = 1).  ``new_kv`` holds (n_periods, B, C, Hkv, Dh)
    rows per position, of which the engine scatters the first
    ``n_valid[b]``.  Logits are taken at column ``n_valid[b] - 1``:
    (B, vocab).  ``kv_block`` sets the prefill kernel's KV block (None =
    the whole view).  PTC scope names equal :func:`build_gateway_step`'s.
    Attention-only: vlm, encdec, MoE, ssm and hybrid archs are refused, as
    the reference refuses them.
    """
    _refuse(cfg)
    if any(sub.kind != "attn" for sub in period_plan(cfg)[0]):
        raise ValueError(
            "chunked prefill supports attention-only archs; ssm/hybrid "
            "token recurrences are sequential — use prefill_chunk=1")

    def attend(p, acfg, lin, h, view, batch):
        h, k_new, v_new = decode_attention_paged_chunked(
            p, acfg, lin, h, view["k"], view["v"], batch["lens"],
            kv_block=kv_block)
        return h, {"k": k_new, "v": v_new}

    def last_column(logits, batch):
        col = (batch["n_valid"].long() - 1)[:, None, None]
        return torch.take_along_dim(logits, col, dim=1)[:, 0]

    return _build_step(cfg, attend, last_column, _stack_new_kv)
