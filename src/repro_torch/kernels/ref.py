"""Plain PyTorch versions of the ported kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.  The kernel wrappers run these on
CPU tensors; on the card they are the reference the kernels are held
against.  Neither is used on the main path when a card is present.
"""

from __future__ import annotations

import torch

__all__ = ["ptc_block_matmul_ref", "mesh_apply_ref", "sigma_grad_ref",
           "feedback_matmul_ref"]


def ptc_block_matmul_ref(x, u, s, v):
    """y[t, p·k+i] = Σ_q (U_pq (s_pq ⊙ (V*_pq x_q)))_i, in fp32.

    x: (T, Q·k); u,v: (P, Q, k, k); s: (P, Q, k)  →  y: (T, P·k), x.dtype
    """
    p, q, k, _ = u.shape
    f32 = torch.float32
    xb = x.to(f32).reshape(x.shape[0], q, k)
    yv = torch.einsum("pqkj,tqj->tpqk", v.to(f32), xb)
    y = torch.einsum("pqik,tpqk->tpi", u.to(f32), yv * s.to(f32))
    return y.reshape(x.shape[0], p * k).to(x.dtype)


def sigma_grad_ref(dy, x, u, v):
    """In-situ Σ-gradient ds_pq = Σ_t (U_pqᵀ δy_p) ⊙ (V*_pq x_q), in fp32.

    dy: (T, P·k); x: (T, Q·k); u,v: (P, Q, k, k)  →  ds: (P, Q, k) fp32
    """
    p, q, k, _ = u.shape
    f32 = torch.float32
    dyb = dy.to(f32).reshape(dy.shape[0], p, k)
    xb = x.to(f32).reshape(x.shape[0], q, k)
    gu = torch.einsum("pqik,tpi->tpqk", u.to(f32), dyb)
    xv = torch.einsum("pqkj,tqj->tpqk", v.to(f32), xb)
    return torch.einsum("tpqk,tpqk->pqk", gu, xv)


def feedback_matmul_ref(dy, u, s, v, mask):
    """Block-masked error feedback dx_q = Σ_p mask[q,p] · W_pqᵀ δy_p, in fp32.

    dy: (T, P·k); u,v: (P, Q, k, k); s: (P, Q, k); mask: (Q, P) scaled
    float  →  dx: (T, Q·k), dy.dtype
    """
    p, q, k, _ = u.shape
    f32 = torch.float32
    dyb = dy.to(f32).reshape(dy.shape[0], p, k)
    gu = torch.einsum("pqik,tpi->tpqk", u.to(f32), dyb)            # Uᵀ δy
    gus = gu * s.to(f32) * mask.to(f32).T[None, :, :, None]     # Σ ⊙ · 𝑃_W
    dx = torch.einsum("pqkj,tpqk->tqj", v.to(f32), gus)          # V ·
    return dx.reshape(dy.shape[0], q * k).to(dy.dtype)


def mesh_apply_ref(x, phases, layer_slot, layer_partner, layer_sign, d=None):
    """Layered mesh  y = U(phases, d) · x  over x's last axis.

    x: (..., k) rows; phases: (..., T) and d: (..., k) | None, batch dims
    broadcast against x's; layer_*: (L, k) schedule tensors (a transpose is
    the reversed schedule with negated signs).  Mirrors
    ``repro.core.unitary.apply_mesh``: ``y = c ⊙ x + s ⊙ x[partner]`` per
    layer, the signs first.
    """
    if d is not None:
        x = x * d
    for sl, pt, sg in zip(layer_slot, layer_partner, layer_sign):
        live = sl >= 0
        ph = phases[..., sl.clamp(min=0)]                      # (..., k)
        c = torch.where(live, torch.cos(ph), 1.0).to(x.dtype)
        s = torch.where(live, torch.sin(ph), 0.0).to(x.dtype) * sg.to(x.dtype)
        x = c * x + s * x[..., pt]
    return x
