"""Neural-net layers over the PTC substrate.

Counterpart of ``repro/models/layers.py``: every projection is a PTC
linear — blockwise (U, Σ, V*) factors with Σ the only first-order-
trainable hardware leaf; embeddings and norms are dense.  Parameters are
plain dicts of tensors; Σ is stored in fp32.

The PTC execution hook and its scope stack (``ptc_execution``,
``ptc_scope``) are here so the LM steps name their layers as the
reference does; the digital gateway installs no hook.  ``mode="dense"``
is the paper's full-space electronic baseline (one trainable ``w``);
``apply_ptc_linear`` reads per-step sampling masks injected into the
parameter tree (the ``fb`` / ``col`` leaves of ``lm.inject_masks``);
``partition`` / ``combine`` split a tree into its trainable and frozen
sides.  ``maybe_constraint`` (a mesh-sharding hint) has no counterpart
on one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from ..core.ptc import PTCParams, random_factorize
from ..core.subspace import SubspaceMasks, ptc_linear

__all__ = ["PTCLinearCfg", "init_ptc_linear", "apply_ptc_linear",
           "is_ptc_leaf", "trainable_mask", "partition", "combine",
           "ptc_execution", "ptc_scope",
           "ptc_scope_name", "init_rmsnorm", "rmsnorm", "init_layernorm",
           "layernorm", "layernorm_np", "rotary_cache", "apply_rotary",
           "softcap", "init_embedding", "embed", "tree_map", "stacked"]

Params = dict

# -- layer-execution hook ----------------------------------------------------
#
# While a hook is installed (``ptc_execution``), every *named* PTC linear
# offers its call to it first: ``hook(name, p, x, cfg, d_out)`` returns the
# layer output computed elsewhere (a photonic chip), or ``None`` to stay
# digital.  Names are qualified by the enclosing ``ptc_scope`` stack (the
# LM steps push ``p{period}.s{sub}.attn`` etc.), so one forward yields the
# reference's stable layer naming.  The port runs eagerly, so the hook
# sees every call (the reference's fires only outside jit/scan).

_PTC_EXEC_HOOK: Callable | None = None
_PTC_SCOPE: list[str] = []


@contextlib.contextmanager
def ptc_execution(hook: Callable):
    """Install ``hook(name, p, x, cfg, d_out) -> y | None`` as the active
    PTC layer executor for the dynamic extent of the block."""
    global _PTC_EXEC_HOOK
    prev, _PTC_EXEC_HOOK = _PTC_EXEC_HOOK, hook
    try:
        yield
    finally:
        _PTC_EXEC_HOOK = prev


@contextlib.contextmanager
def ptc_scope(name: str):
    """Push a qualifier onto the PTC layer-name scope stack."""
    _PTC_SCOPE.append(name)
    try:
        yield
    finally:
        _PTC_SCOPE.pop()


def ptc_scope_name(leaf: str) -> str:
    """Qualified layer name for ``leaf`` under the current scope."""
    return ".".join((*_PTC_SCOPE, leaf))


def _hook_dispatch(p: Params, x: torch.Tensor, cfg: "PTCLinearCfg",
                   d_out: int | None, name: str | None):
    """Offer this call to the active execution hook; None = stay digital."""
    if _PTC_EXEC_HOOK is None or name is None or cfg.mode == "dense" \
            or "u" not in p or p["u"].dim() != 4:
        return None
    return _PTC_EXEC_HOOK(ptc_scope_name(name), p, x, cfg, d_out)


@dataclasses.dataclass(frozen=True)
class PTCLinearCfg:
    """Static policy for every PTC linear in a model."""

    k: int = 128                         # block size (9 = paper)
    mode: str = "fused"                  # fused | blocked | dense
    base_dtype: torch.dtype = torch.bfloat16   # frozen U/V storage dtype
    sigma_dtype: torch.dtype = torch.float32   # trainable Σ dtype


def init_ptc_linear(gen: torch.Generator, d_in: int, d_out: int,
                    cfg: PTCLinearCfg, bias: bool = False) -> Params:
    """One layer's parameters on the generator's device: the factors
    ``u``, ``s``, ``v`` (bases in ``base_dtype``, Σ in ``sigma_dtype``),
    or in ``mode="dense"`` one Glorot-normal ``w`` (d_out, d_in) in
    ``base_dtype``."""
    if cfg.mode == "dense":
        scale = math.sqrt(2.0 / (d_in + d_out))
        p: Params = {"w": (scale * torch.randn(
            (d_out, d_in), generator=gen, device=gen.device)).to(
                cfg.base_dtype)}
    else:
        f = random_factorize(gen, d_out, d_in, cfg.k)
        p = {"u": f.u.to(cfg.base_dtype), "s": f.s.to(cfg.sigma_dtype),
             "v": f.v.to(cfg.base_dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def is_ptc_leaf(path: tuple) -> bool:
    """True for the trainable Σ leaf of a PTC linear (key 's')."""
    return path[-1] == "s"


def apply_ptc_linear(p: Params, x: torch.Tensor, cfg: PTCLinearCfg,
                     masks: SubspaceMasks | None = None,
                     d_out: int | None = None,
                     name: str | None = None) -> torch.Tensor:
    """y = x @ Wᵀ (+b): zero-pads x to the block grid's Q·k columns and
    crops y to ``d_out``.  Σ is cast to the bases' dtype before the
    product, as the reference casts it.  Without ``masks``, the ``fb`` /
    ``col`` leaves of ``p`` (:func:`repro_torch.models.lm.inject_masks`)
    are the step's sampling masks.  ``mode="dense"``: ``x @ wᵀ`` in
    ``w``'s dtype.  ``name`` identifies the layer to an installed
    :func:`ptc_execution` hook; unnamed calls never leave the digital
    path."""
    y = _hook_dispatch(p, x, cfg, d_out, name)
    if y is not None:
        if "b" in p:
            y = y + p["b"].to(y.dtype)
        return y
    if cfg.mode == "dense":
        w = p["w"]
        y = x.to(w.dtype) @ w.T
        if d_out is not None and d_out != w.shape[0]:
            y = y[..., :d_out]
    else:
        if masks is None and ("fb" in p or "col" in p):
            masks = SubspaceMasks(feedback=p.get("fb"), column=p.get("col"))
        params = PTCParams(u=p["u"], s=p["s"].to(p["u"].dtype), v=p["v"])
        pp, qq = params.grid
        k = params.k
        if x.shape[-1] != qq * k:
            x = F.pad(x, (0, qq * k - x.shape[-1]))
        y = ptc_linear(x.to(params.u.dtype), params, masks, mode=cfg.mode)
        if d_out is not None and d_out != pp * k:
            y = y[..., :d_out]
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def trainable_mask(params: Params) -> Params:
    """Bool tree of ``params``' shape: True = the optimizer updates this
    leaf.  Everything but the frozen U/V bases: Σ, biases, norms,
    embeddings, routers and the dense baseline's ``w``."""
    return {name: trainable_mask(leaf) if isinstance(leaf, dict)
            else name not in ("u", "v") for name, leaf in params.items()}


def partition(params: Params, mask: Params) -> tuple[Params, Params]:
    """Split ``params`` into (selected, rest) by the bool tree ``mask``;
    each side holds a scalar zero of the leaf's dtype where the other has
    the leaf, so both keep the full tree structure."""
    def ph(a):
        return torch.zeros((), dtype=a.dtype, device=a.device)

    return (tree_map(lambda a, m: a if m else ph(a), params, mask),
            tree_map(lambda a, m: ph(a) if m else a, params, mask))


def combine(sel: Params, rest: Params, mask: Params) -> Params:
    """The inverse of :func:`partition`."""
    return tree_map(lambda a, b, m: a if m else b, sel, rest, mask)


# -- parameter trees ---------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def stacked(make: Callable[[], Params], n: int) -> Params:
    """``n`` draws of ``make()`` stacked on a new leading axis, filled in
    place one draw at a time (peak memory: the stack plus one draw), as
    the reference's ``jax.vmap`` over split keys lays them out."""
    first = make()
    out = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    tree_map(lambda o, a: o[0].copy_(a), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, a, i=i: o[i].copy_(a), out, make())
    return out


# -- norms -------------------------------------------------------------------
# fp32 inside, cast back to the input's dtype, as the reference does.


def init_rmsnorm(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * p["g"]).to(x.dtype)


def init_layernorm(d: int, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device),
            "b": torch.zeros((d,), dtype=torch.float32, device=device)}


def _standardize(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (_standardize(x, eps) * p["g"] + p["b"]).to(x.dtype)


def layernorm_np(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm (no affine params)."""
    return _standardize(x, eps).to(x.dtype)


# -- rotary ------------------------------------------------------------------


def rotary_cache(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0, frac: float = 1.0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, (..., rot_dim/2).  ``frac`` < 1 = partial rotary
    (chatglm's 2d-RoPE rotates the leading half of the head dim)."""
    rot = int(head_dim * frac) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=positions.device) / rot))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (..., S, rot/2) broadcast over H.

    Rotates *interleaved* pairs (x[2i], x[2i+1]), as the reference does,
    not the half-split layout."""
    rot2 = cos.shape[-1]
    xr, xp = x[..., : 2 * rot2], x[..., 2 * rot2:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap·tanh(x/cap), in fp32."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# -- embedding ---------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.bfloat16) -> Params:
    return {"e": (torch.randn((vocab, d), generator=gen, device=gen.device)
                  * (d ** -0.5)).to(dtype)}


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not p["e"][tokens]: the same gather, but its backward
    # sums each row's gradient in one order, where the index backward
    # (index_put_ with accumulate) on several CPU threads sums repeated
    # tokens in whatever order the threads reach them
    return F.embedding(tokens, p["e"])
