"""Subspace learning: first-order training of Σ with in-situ gradients.

Counterpart of ``repro/core/subspace.py``.  The paper's SL stage (§3.4)
trains only the singular values; the gradients come in situ by
reciprocity (Eq. 5):

    ∂L/∂Σ_pq = Σ_t (U_pqᵀ ∂L/∂y_p) ⊙ (V*_pq x_q)
    ∂L/∂x_q  = Σ_p 𝑃_W[q,p] · V*_pqᵀ (Σ_pq ⊙ (U_pqᵀ ∂L/∂y_p))

:func:`ptc_linear` is a ``torch.autograd.Function`` with that backward, in
two modes:

* ``blocked`` — the paper's dataflow: the forward is the PTC kernel
  (``ptc_block_matmul``), the backward the ``sigma_grad`` kernel on the
  column-masked δy and the ``feedback_matmul`` kernel with the block mask;
* ``fused`` — forward through the recomposed ``W_eff``, backward through
  the dense ``δyᵀx`` and its block-diagonal projection (plain PyTorch: no
  TPU kernel computes it).

Feedback / column masks are sampled outside (:mod:`.sparsity`) and passed
in; ``None`` means dense.  ``u`` and ``v`` get no gradient: the bases are
frozen hardware state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.feedback_matmul import feedback_matmul
from ..kernels.ptc_block_matmul import ptc_block_matmul
from ..kernels.sigma_grad import sigma_grad
from .ptc import PTCParams, block_energy, blockize, compose_weight, unblockize
from .sparsity import SparsityConfig, column_mask, feedback_mask

__all__ = ["ptc_linear", "ptc_linear_ref", "SubspaceMasks", "sample_masks"]

MODES = ("fused", "blocked")


class SubspaceMasks(NamedTuple):
    """Per-layer sampling masks for one optimization step."""

    feedback: torch.Tensor | None  # (Q, P) scaled block mask on W^T
    column: torch.Tensor | None    # (T,) scaled token/column mask


def sample_masks(gen: torch.Generator, params: PTCParams, n_tokens: int,
                 cfg: SparsityConfig) -> SubspaceMasks:
    """Draw the step's feedback + column masks for one PTC weight (the
    feedback mask first, then the columns, from one generator)."""
    with torch.no_grad():
        fb = feedback_mask(gen, block_energy(params), cfg) \
            if cfg.alpha_w < 1.0 else None
    col = column_mask(gen, n_tokens, cfg) if cfg.alpha_c < 1.0 else None
    return SubspaceMasks(feedback=fb, column=col)


class _PTCLinear(torch.autograd.Function):
    """y = x @ W(U, Σ, V*)ᵀ with the in-situ backward; x: (T, Q·k)."""

    @staticmethod
    def forward(ctx, x, s, u, v, fb, col, mode):
        ctx.mode = mode
        ctx.save_for_backward(x, s, u, v, fb, col)
        if mode == "fused":
            return x @ unblockize(compose_weight(PTCParams(u, s, v))).T
        return ptc_block_matmul(x, u, s, v)

    @staticmethod
    def backward(ctx, dy):
        x, s, u, v, fb, col = ctx.saved_tensors
        need_dx, need_ds = ctx.needs_input_grad[:2]
        k = u.shape[-1]
        dy = dy.contiguous()
        dx = ds = None
        if ctx.mode == "fused":
            # dW = δyᵀ·(col ⊙ x); ds_pq = diag(U_pqᵀ dW_pq V*_pqᵀ).  The
            # fp32 masks promote bf16 operands to fp32, as in the reference
            if need_ds:
                xw = x if col is None else x * col[:, None]
                dt = torch.promote_types(dy.dtype, xw.dtype)
                dwb = blockize(dy.to(dt).T @ xw.to(dt), k)
                udw = torch.einsum("pqji,pqjl->pqil", u.to(dt), dwb)
                ds = torch.einsum("pqil,pqil->pqi", udw, v.to(dt)).to(s.dtype)
            if need_dx:
                w = compose_weight(PTCParams(u, s, v))
                if fb is not None:
                    w = w * fb.T[:, :, None, None]
                dt = torch.promote_types(dy.dtype, w.dtype)
                dx = (dy.to(dt) @ unblockize(w).to(dt)).to(x.dtype)
        else:
            if need_ds:
                ds = sigma_grad(dy, x, u, v, col).to(s.dtype)
            if need_dx:
                mask = fb.contiguous() if fb is not None else torch.ones(
                    (u.shape[1], u.shape[0]), dtype=torch.float32,
                    device=dy.device)
                dx = feedback_matmul(dy, u, s, v, mask).to(x.dtype)
        return dx, ds, None, None, None, None, None


def ptc_linear(x: torch.Tensor, params: PTCParams,
               masks: SubspaceMasks | None = None, *,
               mode: str = "fused") -> torch.Tensor:
    """Public PTC linear: y = x @ W(params)ᵀ with the in-situ subspace VJP.

    ``x``'s last dim must equal Q·k (pad in the layer wrapper); the output
    is (..., P·k).  ``mode``: "fused" or "blocked" (the kernels' dataflow;
    fp32 or bf16, any k; the gradients come back in x's and s's dtypes).
    Only ``x`` and ``params.s`` receive gradients.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode: {mode!r}")
    p, q = params.grid
    k = params.k
    if x.shape[-1] != q * k:
        raise ValueError(f"ptc_linear: x has {x.shape[-1]} features, the "
                         f"block grid needs Q·k = {q * k}")
    fb = masks.feedback if masks is not None else None
    col = masks.column if masks is not None else None
    lead = x.shape[:-1]
    rows = x.numel() // (q * k)
    if col is not None and tuple(col.shape) != (rows,):
        # the reference fails here too (a broadcast of the column mask
        # against δy): a mask drawn for B·S tokens on a layer that reads
        # another number of rows, as vlm's cross-attention K/V do
        raise ValueError(f"ptc_linear: the column mask has "
                         f"{tuple(col.shape)} entries, the layer reads "
                         f"{rows} rows")
    y = _PTCLinear.apply(x.reshape(-1, q * k).contiguous(),
                         params.s.contiguous(), params.u.contiguous(),
                         params.v.contiguous(), fb, col, mode)
    return y.reshape(lead + (p * k,))


def ptc_linear_ref(x: torch.Tensor, params: PTCParams) -> torch.Tensor:
    """Plain-autograd oracle (no custom backward, no sampling) for tests."""
    return x @ unblockize(compose_weight(params)).T
