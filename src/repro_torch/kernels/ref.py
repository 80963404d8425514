"""Plain PyTorch versions of the ported kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.  The kernel wrappers run these on
CPU tensors; on the card they are the reference the kernels are held
against.  Neither is used on the main path when a card is present.
"""

from __future__ import annotations

import torch

__all__ = ["ptc_block_matmul_ref", "mesh_apply_ref", "sigma_grad_ref",
           "ptc_block_matmul_tc_ref", "sigma_grad_tc_ref", "split_bf16",
           "split_tf32", "ptc_block_matmul_3xtf32_ref",
           "sigma_grad_3xtf32_ref", "feedback_matmul_ref",
           "feedback_matmul_tc_ref", "feedback_matmul_3xtf32_ref",
           "paged_gather_ref", "paged_scatter_ref", "prefill_attention_ref",
           "NEG_INF"]

NEG_INF = -2.0 ** 30    # prefill attention's finite floor for masked logits


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


def sigma_grad_ref(dy, x, u, v, col=None):
    """In-situ Σ-gradient ds_pq = Σ_t col_t (U_pqᵀ δy_p) ⊙ (V*_pq x_q), in
    fp32.

    dy: (T, P·k); x: (T, Q·k); u,v: (P, Q, k, k); col: (T,) fp32 column
    scale or None  →  ds: (P, Q, k) fp32
    """
    p, q, k, _ = u.shape
    f32 = torch.float32
    dyf = dy.to(f32) if col is None else dy.to(f32) * col[:, None]
    dyb = dyf.reshape(dy.shape[0], p, k)
    xb = x.to(f32).reshape(x.shape[0], q, k)
    gu = torch.einsum("pqik,tpi->tpqk", u.to(f32), dyb)
    xv = torch.einsum("pqkj,tqj->tpqk", v.to(f32), xb)
    return torch.einsum("tpqk,tpqk->pqk", gu, xv)


def split_bf16(a):
    """fp32 ``a`` as bf16 ``(hi, lo)``: hi = bf16(a), lo = bf16(a - hi), so
    hi + lo lies within 2^-17 of a."""
    hi = a.to(torch.bfloat16)
    return hi, (a - hi.to(a.dtype)).to(torch.bfloat16)


def ptc_block_matmul_tc_ref(x, u, s, v):
    """The tensor-core route's roundings of :func:`ptc_block_matmul_ref`:
    U_pq diag(s_pq) rounded once to bf16, W_pq = (U diag(s)) V*_pq summed
    in fp32 and rounded once to bf16, y = x Wᵀ summed in fp32 and rounded
    to bf16 (the kernel sums in another order).

    x: (T, Q·k); u,v: (P, Q, k, k); s: (P, Q, k), all bf16  →  y bf16
    """
    p, q, k, _ = u.shape
    f32, b16 = torch.float32, torch.bfloat16
    us = (u.to(f32) * s.to(f32)[:, :, None, :]).to(b16).to(f32)
    w = torch.einsum("pqia,pqaj->piqj", us, v.to(f32)).to(b16).to(f32)
    return (x.to(f32) @ w.reshape(p * k, q * k).T).to(b16)


def sigma_grad_tc_ref(dy, x, u, v, col=None):
    """The tensor-core route's roundings of :func:`sigma_grad_ref`: with a
    column scale, ``col ⊙ δy`` formed in fp32 and split into bf16 hi + lo
    (:func:`split_bf16`), G = Σ over the parts of partᵀx in fp32 (δy alone
    without one); G split into bf16 hi + lo, H_pq = U_pqᵀ(G_hi + G_lo) and
    ds_pq[i] = Σ_b H_pq[i, b] V*_pq[i, b] in fp32.

    dy: (T, P·k); x: (T, Q·k); u,v: (P, Q, k, k), all bf16; col: (T,) fp32
    or None  →  ds: (P, Q, k) fp32
    """
    p, q, k, _ = u.shape
    f32 = torch.float32
    parts = (dy,) if col is None else split_bf16(dy.to(f32) * col[:, None])
    xf = x.to(f32)
    g = sum(part.to(f32).T @ xf for part in parts)            # (P·k, Q·k)
    g = g.reshape(p, k, q, k).permute(0, 2, 1, 3)              # (P, Q, a, b)
    h = sum(torch.einsum("pqai,pqab->pqib", u.to(f32), part.to(f32))
            for part in split_bf16(g))
    return (h * v.to(f32)).sum(-1)


def split_tf32(a):
    """fp32 ``a`` as tf32 ``(hi, lo)``, both fp32 words with their low 13
    bits zero: hi rounds a to tf32's grid, to nearest with ties away from
    zero (``cvt.rna.tf32.f32``: add 0x1000 to the bits, clear the low 13),
    lo rounds a - hi (exact in fp32) the same way; hi + lo lies within
    about 2^-22 of |a|."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    a = a.to(torch.float32)
    hi = rna(a)
    return hi, rna(a - hi)


def _mm_3xtf32(a, b):
    """a @ b as the 3xTF32 kernels form it: lo·hi + hi·lo + hi·hi of the
    tf32 splits (each product exact in fp32), summed in fp32; lo·lo
    dropped."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def ptc_block_matmul_3xtf32_ref(x, u, s, v):
    """The 3xTF32 route's arithmetic of :func:`ptc_block_matmul_ref`: U_pq
    diag(s_pq) formed in fp32, W_pq = (U diag(s)) V*_pq and y = x Wᵀ each
    on 3xTF32 (:func:`split_tf32`), summed in fp32 (the kernel sums in
    another order).

    x: (T, Q·k); u,v: (P, Q, k, k); s: (P, Q, k), all fp32  →  y fp32
    """
    p, q, k, _ = u.shape
    us = u * s[:, :, None, :]
    w = _mm_3xtf32(us, v)                                      # (P, Q, i, j)
    w = w.permute(0, 2, 1, 3).reshape(p * k, q * k)
    return _mm_3xtf32(x, w.T)


def sigma_grad_3xtf32_ref(dy, x, u, v, col=None):
    """The 3xTF32 route's arithmetic of :func:`sigma_grad_ref`: ``col ⊙
    δy`` formed in fp32, G = (col ⊙ δy)ᵀ x on 3xTF32 (:func:`split_tf32`),
    then H_pq = U_pqᵀ G_pq and ds_pq[i] = Σ_b H_pq[i, b] V*_pq[i, b] in
    fp32 (the kernel sums in another order).

    dy: (T, P·k); x: (T, Q·k); u,v: (P, Q, k, k), all fp32; col: (T,) fp32
    or None  →  ds: (P, Q, k) fp32
    """
    p, q, k, _ = u.shape
    a = dy if col is None else dy * col[:, None]
    g = _mm_3xtf32(a.T, x)                                     # (P·k, Q·k)
    g = g.reshape(p, k, q, k).permute(0, 2, 1, 3)              # (P, Q, a, b)
    h = torch.einsum("pqai,pqab->pqib", u, g)
    return (h * v).sum(-1)


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


def feedback_matmul_tc_ref(dy, u, s, v, mask):
    """The tensor-core route's roundings of :func:`feedback_matmul_ref`:
    U_pq diag(s_pq) scaled by mask[q, p] in fp32 and rounded once to bf16,
    W̃_pq = (U diag(s) mask) V*_pq summed in fp32 and rounded once to bf16,
    dx = δy W̃ summed in fp32 and rounded to bf16 (the kernel sums in
    another order and skips the masked blocks, which add zeros here).

    dy: (T, P·k); u,v: (P, Q, k, k); s: (P, Q, k), all bf16; mask: (Q, P)
    scaled fp32  →  dx: (T, Q·k) bf16
    """
    p, q, k, _ = u.shape
    f32, b16 = torch.float32, torch.bfloat16
    us = (u.to(f32) * s.to(f32)[:, :, None, :]) * mask.to(f32).T[:, :, None,
                                                                 None]
    w = torch.einsum("pqia,pqaj->piqj", us.to(b16).to(f32), v.to(f32))
    w = w.to(b16).to(f32).reshape(p * k, q * k)
    return (dy.to(f32) @ w).to(b16)


def feedback_matmul_3xtf32_ref(dy, u, s, v, mask):
    """The 3xTF32 route's arithmetic of :func:`feedback_matmul_ref`: U_pq
    diag(s_pq) scaled by mask[q, p] in fp32, W̃ᵀ_pq = V*_pqᵀ (U diag(s)
    mask)ᵀ and dx = δy W̃ each on 3xTF32 (:func:`split_tf32`), summed in
    fp32 (the kernel sums in another order and skips the masked blocks,
    which add zeros here).

    dy: (T, P·k); u,v: (P, Q, k, k); s: (P, Q, k), all fp32; mask: (Q, P)
    scaled fp32  →  dx: (T, Q·k) fp32
    """
    p, q, k, _ = u.shape
    us = (u * s[:, :, None, :]) * mask.T[:, :, None, None]
    wt = _mm_3xtf32(v.transpose(-1, -2), us.transpose(-1, -2))  # (P, Q, j, i)
    return _mm_3xtf32(dy, wt.permute(0, 3, 1, 2).reshape(p * k, q * k))


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


def paged_gather_ref(table, pages):
    """Per-slot contiguous views of a paged pool, in one indexing call.

    table: (B, J) int32 page ids; pages: (n_pages, ps, d)  →  (B, J·ps, d)
    """
    b, j = table.shape
    if table.numel() and (table.min() < 0 or table.max() >= pages.shape[0]):
        raise IndexError("paged_gather: a page id lies outside the pool")
    return pages[table.long()].reshape(b, j * pages.shape[1], pages.shape[2])


def paged_scatter_ref(idx, rows, pages):
    """Write ``rows[r]`` at ``pages[idx[r, 0], idx[r, 1]]`` in place and
    return ``pages``; duplicate targets resolve last-wins, made explicit:
    only the last occurrence of each target takes part in one
    ``index_put_``.

    idx: (R, 2) int32; rows: (R, d); pages: (n_pages, ps, d)
    """
    n_pages, ps, d = pages.shape
    pid, off = idx[:, 0].long(), idx[:, 1].long()
    if idx.shape[0] and (pid.min() < 0 or pid.max() >= n_pages
                         or off.min() < 0 or off.max() >= ps):
        raise ValueError("paged_scatter: a target lies outside the pool")
    flat = pid * ps + off
    order = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((n_pages * ps,), -1, dtype=torch.long,
                      device=flat.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    keep = last[flat] == order
    pages.view(n_pages * ps, d).index_put_((flat[keep],), rows[keep])
    return pages


def prefill_attention_ref(lens, q, k, v, window=None, cap=None):
    """Dense masked softmax in fp32 with the kernel's masking discipline:
    masked logits take the finite floor ``NEG_INF`` before the max and
    their probabilities are zeroed by the mask.

    lens: (B,) int; q: (B, C, H, Dh); k, v: (B, S, Hkv, Dh)  →  (B, C, H,
    Dh) in q's dtype
    """
    b, c, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    kr = k.to(f32).repeat_interleave(h // hkv, dim=2)   # head h -> h // rep
    vr = v.to(f32).repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kr) * hd ** -0.5
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    qi = lens.long()[:, None] + torch.arange(c, device=q.device)[None, :]
    ki = torch.arange(s, device=q.device)
    ok = ki[None, None, :] <= qi[:, :, None]                     # (B, C, S)
    if window is not None:
        ok = ok & (ki[None, None, :] > qi[:, :, None] - window)
    ok = ok[:, None]                                           # (B, 1, C, S)
    logits = torch.where(ok, logits, NEG_INF)
    p = torch.where(ok, torch.exp(logits - logits.amax(-1, keepdim=True)),
                    0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vr) \
        / p.sum(-1).transpose(1, 2)[..., None]
    return out.to(q.dtype)
