"""Block-masked error feedback ``dx_q = Σ_p 𝑃_W[q,p]·W_pqᵀ δy_p``: the wrapper.

Counterpart of ``repro/kernels/feedback_matmul.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernels in ``csrc/feedback_matmul.cu``: two pre-passes into scratch this
wrapper allocates (each kept block composed once, ``W̃_pq =
𝑃_W[q,p]·U_pq diag(s_pq) V*_pq``, and δy transposed so a row tile of one
block column is contiguous), then the register-tiled product that skips
masked blocks whole.  On a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.feedback_matmul_ref`).  :func:`plan` picks
the kernel's compiled k and its rows per lane.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import feedback_matmul_ref

__all__ = ["feedback_matmul", "plan", "MAX_K"]

NAME = "feedback_matmul"
MAX_K = 32
_MAX_ROW_TILES = 65535   # grid.y limit (the transpose's tiles are 32 rows)
# the k the kernel is compiled for, and its most rows per lane (acc regs)
_KERNEL_K = (4, 8, 9, 16, 32)
_MAX_ROWS_PER_LANE = {4: 8, 8: 8, 9: 8, 16: 4, 32: 2}


def plan(t: int, k: int) -> tuple[int, int, int]:
    """``(kt, kp, rt)`` for T rows of block size k: the compiled block size
    ``kt`` (the least of 4, 8, 9, 16, 32 that holds k), the scratch row
    width ``kp`` (kt rounded up to a multiple of 4: float4 loads), and the
    rows per lane ``rt`` (a power of two, at most what kt's accumulators
    allow; no more than T needs, so a CTA of 32·rt rows wastes little on
    a short T)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"feedback_matmul: k = {k} outside 1..{MAX_K}")
    kt = next(c for c in _KERNEL_K if c >= k)
    rt = 1
    while rt < _MAX_ROWS_PER_LANE[kt] and 32 * rt < t:
        rt *= 2
    return kt, -(-kt // 4) * 4, rt


def _lib():
    fn = build.library(NAME).feedback_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def feedback_matmul(dy: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                    v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """dy: (T, P·k), u/v: (P, Q, k, k), s: (P, Q, k), mask: (Q, P) scaled
    → dx: (T, Q·k).

    All fp32, contiguous, on one device.  Blocks whose mask entry is 0 are
    skipped; a row of the mask with no kept block gives an exact zero.
    """
    if dy.dim() != 2 or u.dim() != 4 or v.shape != u.shape \
            or s.shape != u.shape[:3] or u.shape[2] != u.shape[3]:
        raise ValueError(f"feedback_matmul: bad shapes dy{tuple(dy.shape)} "
                         f"u{tuple(u.shape)} s{tuple(s.shape)} "
                         f"v{tuple(v.shape)}")
    p, q, k, _ = u.shape
    t = dy.shape[0]
    if dy.shape[1] != p * k or mask.shape != (q, p):
        raise ValueError(f"feedback_matmul: dy has {dy.shape[1]} columns and "
                         f"mask shape {tuple(mask.shape)}; the block grid "
                         f"needs P·k = {p * k} and (Q, P) = {(q, p)}")
    if any(a.dtype != torch.float32 for a in (dy, u, s, v, mask)):
        raise TypeError("feedback_matmul: dy, u, s, v, mask must be float32; "
                        f"got {dy.dtype}, {u.dtype}, {s.dtype}, {v.dtype}, "
                        f"{mask.dtype}")
    if len({a.device for a in (dy, u, s, v, mask)}) != 1:
        raise ValueError("feedback_matmul: inputs lie on different devices")
    if not all(a.is_contiguous() for a in (dy, u, s, v, mask)):
        raise ValueError("feedback_matmul: inputs must be contiguous")
    if dy.device.type == "cpu":
        return feedback_matmul_ref(dy, u, s, v, mask)
    if dy.device.type != "cuda":
        raise ValueError(f"feedback_matmul: unsupported device {dy.device}")
    kt, kp, rt = plan(t, k)
    dx = torch.empty((t, q * k), dtype=torch.float32, device=dy.device)
    if t == 0 or q == 0:
        return dx
    if -(-t // 32) > _MAX_ROW_TILES or q >= 2 ** 31:
        raise ValueError(f"feedback_matmul: grid too large (T={t}, Q={q})")
    rows = 32 * rt
    wt = torch.empty((p, q, k, kp), dtype=torch.float32, device=dy.device)
    dyt = torch.empty((p * k, -(-t // rows) * rows), dtype=torch.float32,
                      device=dy.device)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib()(dy.data_ptr(), u.data_ptr(), s.data_ptr(),
                        v.data_ptr(), mask.data_ptr(), wt.data_ptr(),
                        dyt.data_ptr(), dx.data_ptr(), t, p, q, k, kt, rt,
                        stream)
    build.check_status(NAME, status)
    build.launch_counts[NAME] += 1
    return dx
