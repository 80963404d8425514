"""LM assembly from PTC layers: dense, MoE, ssm and hybrid decoder stacks.

Counterpart of ``repro/models/lm.py`` for what the serving paths run (the
solo serve step over a dense decode cache, and the gateway's steps):
architectures are described by :class:`ArchConfig` and composed as
``n_periods`` repetitions of a static *period plan* (gemma2's local/global
alternation is a period of two attention sub-layers, jamba's a period of
one attention and seven mamba sub-layers with MoE on every other one);
per-position parameters are stacked on a leading period axis, as the
reference's ``jax.vmap`` init gives them, and the steps walk the periods
in a Python loop (the reference scans them), pushing the reference's PTC
scope names ``p{period}.s{sub}.attn`` / ``.mamba`` / ``.mlp``.  The MoE
experts run unscoped and are never offered to the execution hook, as the
reference's run under ``vmap``.

The vlm and encdec families (cross-attention, the encoder stack) raise:
they are the next slice of the port (ROADMAP.md, queue 1, "LM families
beyond dense attention").  Training (``forward``, ``build_train_step``,
``inject_masks``) belongs to a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .attention import (AttnCfg, decode_attention, decode_attention_paged,
                        decode_attention_paged_chunked, init_attention,
                        init_kv_cache)
from .ffn import FFNCfg, MoECfg, init_mlp, init_moe, mlp, moe
from .layers import (PTCLinearCfg, embed, init_embedding, init_layernorm,
                     init_rmsnorm, layernorm, layernorm_np, ptc_scope,
                     rmsnorm, softcap, stacked, tree_map)
from .ssm import SSMCfg, init_mamba, init_ssm_state, mamba_decode

__all__ = ["ArchConfig", "SubLayerPlan", "period_plan", "init_model",
           "init_decode_cache", "build_serve_step", "build_gateway_step",
           "build_gateway_prefill_step"]

Params = dict


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid
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
    # norms / activations / embeddings
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam
    act: str = "silu"
    post_norm: bool = False         # gemma2 sandwich norm
    tie_embed: bool = True
    # substrate policy
    ptc: PTCLinearCfg = dataclasses.field(default_factory=PTCLinearCfg)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def attn_cfg(self, window=None) -> AttnCfg:
        return AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                       n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                       rope_theta=self.rope_theta, rope_frac=self.rope_frac,
                       qk_norm=self.qk_norm, attn_softcap=self.attn_softcap,
                       qkv_bias=self.qkv_bias, window=window)

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


def _periods(cfg: ArchConfig, length: int, what: str) -> int:
    if cfg.n_layers % length:
        raise ValueError(f"{cfg.name}: {what} needs a layer count divisible "
                         f"by {length}, got {cfg.n_layers}")
    return cfg.n_layers // length


def period_plan(cfg: ArchConfig) -> tuple[list[SubLayerPlan], int]:
    """(plan, n_periods): the static per-period sub-layer schedule."""
    if cfg.family in ("vlm", "encdec"):
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(cross-attention and the encoder stack are the next slice: "
            f"ROADMAP.md, queue 1, 'LM families beyond dense attention')")
    ffn = "moe" if (cfg.n_experts > 0 and cfg.attn_period == 0) else "mlp"
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
    unembedding when untied) in the base dtype, fp32 norms and Σ, and one
    ``pos{i}`` tree per plan position stacked over the periods."""
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
    return params


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
        x = _apply_norm(cfg, params["final_norm"], x)
        w = params["embed"]["e"] if cfg.tie_embed else params["unembed"]["w"]
        logits = softcap(x @ w.T, cfg.final_softcap)
        return last_column(logits, batch), collect(state, outs)

    return step


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
    same position.  Each attention layer's new K/V row is written into
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


def _refuse_moe(cfg: ArchConfig) -> None:
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
    mamba position's whole replacement state.  Logits: (B, vocab).  MoE
    archs are refused, as the reference refuses them."""
    _refuse_moe(cfg)

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
    Attention-only: MoE, ssm and hybrid archs are refused, as the
    reference refuses them.
    """
    _refuse_moe(cfg)
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
