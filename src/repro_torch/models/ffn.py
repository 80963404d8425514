"""Feed-forward layers: the gated MLP and the top-k MoE over PTC linears.

Counterpart of ``repro/models/ffn.py``.  MoE dispatch is the reference's
group-wise sort: each batch row is a dispatch group whose (token, expert)
assignments are stably sorted by expert, given capacity-bounded slots of
an (E, C, d) buffer (overflow dropped), run through the experts, and
gathered back gate-weighted.  Every expert's factors carry a leading E
axis; the fused experts run as one batched compose and one batched
product per projection, outside any execution hook (the reference runs
them under ``jax.vmap``, where its hook is inert).  The reference's
shard_map all-to-all (``moe_dispatch="a2a"``) needs a device mesh; on one
device the reference falls through to the group-wise path, and so does
the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import (PTCLinearCfg, apply_ptc_linear, init_ptc_linear,
                     stacked, tree_map)

__all__ = ["FFNCfg", "init_mlp", "mlp", "MoECfg", "init_moe", "moe"]

Params = dict


@dataclasses.dataclass(frozen=True)
class FFNCfg:
    d_model: int
    d_ff: int
    act: str = "silu"      # silu | gelu


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":             # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_mlp(gen: torch.Generator, cfg: FFNCfg, lin: PTCLinearCfg) -> Params:
    return {
        "gate": init_ptc_linear(gen, cfg.d_model, cfg.d_ff, lin),
        "up": init_ptc_linear(gen, cfg.d_model, cfg.d_ff, lin),
        "down": init_ptc_linear(gen, cfg.d_ff, cfg.d_model, lin),
    }


def mlp(p: Params, cfg: FFNCfg, lin: PTCLinearCfg,
        x: torch.Tensor) -> torch.Tensor:
    g = apply_ptc_linear(p["gate"], x, lin, d_out=cfg.d_ff, name="gate")
    u = apply_ptc_linear(p["up"], x, lin, d_out=cfg.d_ff, name="up")
    return apply_ptc_linear(p["down"], _act(cfg.act, g) * u, lin,
                            d_out=cfg.d_model, name="down")


# -- MoE ---------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int               # per-expert hidden dim
    n_experts: int
    top_k: int
    act: str = "silu"
    capacity_factor: float = 1.25
    balance_coeff: float = 0.01
    dispatch: str = "pjit"  # pjit | a2a (one device: the same path)


def init_moe(gen: torch.Generator, cfg: MoECfg, lin: PTCLinearCfg) -> Params:
    """Router (E, d) in fp32 and E experts' MLPs stacked on a leading E
    axis, on the generator's device."""
    fcfg = FFNCfg(cfg.d_model, cfg.d_ff, cfg.act)
    experts = stacked(lambda: init_mlp(gen, fcfg, lin), cfg.n_experts)
    router = torch.randn((cfg.n_experts, cfg.d_model), generator=gen,
                         device=gen.device) * (cfg.d_model ** -0.5)
    return {"router": router, "experts": experts}


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties in index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_linear(p: Params, x: torch.Tensor, lin: PTCLinearCfg,
                   d_out: int) -> torch.Tensor:
    """Every expert's PTC linear: x (E, T, d_in) → (E, T, d_out).  The
    blocked mode, and sampling masks injected into the tree, take each
    expert through :func:`apply_ptc_linear` (its in-situ backward)."""
    if lin.mode != "fused" or "fb" in p or "col" in p:
        return torch.stack([apply_ptc_linear(
            tree_map(lambda a, i=i: a[i], p), x[i], lin, d_out=d_out)
            for i in range(x.shape[0])])
    u, v = p["u"], p["v"]
    e, pp, qq, k, _ = u.shape
    w = (u * p["s"].to(u.dtype)[..., None, :]) @ v       # (E, P, Q, k, k)
    w = w.permute(0, 1, 3, 2, 4).reshape(e, pp * k, qq * k)
    x = x.to(u.dtype)
    if x.shape[-1] != qq * k:
        x = F.pad(x, (0, qq * k - x.shape[-1]))
    return torch.bmm(x, w.transpose(1, 2))[..., :d_out]


def _experts(p: Params, cfg: MoECfg, lin: PTCLinearCfg,
             buf: torch.Tensor) -> torch.Tensor:
    """The expert MLPs over their buffers: (B, E, C, d) → (B, E, C, d)."""
    b, e, c, d = buf.shape
    xe = buf.transpose(0, 1).reshape(e, b * c, d)
    g = _expert_linear(p["gate"], xe, lin, cfg.d_ff)
    u = _expert_linear(p["up"], xe, lin, cfg.d_ff)
    y = _expert_linear(p["down"], _act(cfg.act, g) * u, lin, cfg.d_model)
    return y.reshape(e, b, c, d).transpose(0, 1)


def moe(p: Params, cfg: MoECfg, lin: PTCLinearCfg, x: torch.Tensor
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y, aux_balance_loss), one dispatch group per row."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    cap = min(s * k, max(1, int(s * k / e * cfg.capacity_factor)))

    # -- routing (per token)
    logits = x.float() @ p["router"].T                          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = _top_k(probs, k)                               # (B, S, K)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)

    # -- load-balance aux (Switch-style)
    frac = F.one_hot(idx[..., 0], e).float().mean((0, 1))
    aux = cfg.balance_coeff * e * torch.sum(frac * probs.mean((0, 1)))

    # -- per-group stable sort → slot assignment; overflow goes to slot
    # e·cap, a dump column cut off after the scatter
    sk = s * k
    flat_e = idx.reshape(b, sk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    tok = order // k                                            # source token
    sorted_e = torch.gather(flat_e, 1, order)
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=dev).expand(b, e).contiguous())
    pos = torch.arange(sk, device=dev)[None] - torch.gather(
        group_start, 1, sorted_e)                               # rank in expert
    valid = pos < cap
    slot = torch.where(valid, sorted_e * cap + pos, e * cap)
    inv = torch.full((b, e * cap + 1), sk, dtype=torch.int64, device=dev)
    inv.scatter_(1, slot, torch.arange(sk, device=dev).expand(b, sk))
    inv = inv[:, :e * cap]                      # which assignment fills a slot
    tok_pad = torch.cat([tok, tok.new_zeros((b, 1))], dim=1)
    src = torch.gather(tok_pad, 1, inv)                         # (B, E·C)
    slot_valid = (inv < sk)[..., None]

    # -- gather into the per-group expert buffers, run the experts
    buf = torch.gather(x, 1, src[..., None].expand(b, e * cap, d)) \
        * slot_valid.to(x.dtype)
    out = _experts(p["experts"], cfg, lin, buf.reshape(b, e, cap, d))
    out = out.reshape(b, e * cap, d)

    # -- gather-combine in token order
    inv_order = torch.argsort(order, dim=-1, stable=True)
    slot_tok = torch.gather(torch.clamp(slot, max=e * cap - 1), 1, inv_order)
    valid_tok = torch.gather(valid, 1, inv_order)
    got = torch.gather(out, 1, slot_tok[..., None].expand(b, sk, d))
    got = got * valid_tok[..., None].to(got.dtype)
    got = got.reshape(b, s, k, d) * gates[..., None].to(got.dtype)
    return got.sum(2).to(x.dtype), aux
