"""Block-masked error feedback ``dx_q = Σ_p 𝑃_W[q,p]·W_pqᵀ δy_p``: the wrapper.

Counterpart of ``repro/kernels/feedback_matmul.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/feedback_matmul.cu``, which skips masked blocks whole; on
a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.feedback_matmul_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import feedback_matmul_ref

__all__ = ["feedback_matmul", "MAX_K"]

NAME = "feedback_matmul"
MAX_K = 32
_MAX_ROW_TILES = 65535   # grid.y limit; row tiles are 128 rows


def _lib():
    fn = build.library(NAME).feedback_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
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
    if k > MAX_K:
        raise ValueError(f"feedback_matmul: k = {k} > {MAX_K}")
    dx = torch.empty((t, q * k), dtype=torch.float32, device=dy.device)
    if t == 0 or q == 0:
        return dx
    if -(-t // 128) > _MAX_ROW_TILES or q >= 2 ** 31:
        raise ValueError(f"feedback_matmul: grid too large (T={t}, Q={q})")
    plist = torch.empty((q, p), dtype=torch.int32, device=dy.device)
    counts = torch.empty((q,), dtype=torch.int32, device=dy.device)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib()(dy.data_ptr(), u.data_ptr(), s.data_ptr(),
                        v.data_ptr(), mask.data_ptr(), plist.data_ptr(),
                        counts.data_ptr(), dx.data_ptr(), t, p, q, k, stream)
    build.check_status(NAME, status)
    build.launch_counts[NAME] += 1
    return dx
