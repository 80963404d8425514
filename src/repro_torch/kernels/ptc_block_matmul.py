"""Blocked PTC forward ``y_p = Σ_q U_pq(Σ_pq ⊙ (V*_pq x_q))``: the wrapper.

Counterpart of ``repro/kernels/ptc_block_matmul.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/ptc_block_matmul.cu``; on a CPU tensor it runs the plain
PyTorch version (:func:`repro_torch.kernels.ref.ptc_block_matmul_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import ptc_block_matmul_ref

__all__ = ["ptc_block_matmul", "MAX_K"]

NAME = "ptc_block_matmul"
MAX_K = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROW_TILES = 65535   # grid.y limit; row tiles are 128 rows


def _lib():
    lib = build.library(NAME)
    fn = lib.ptc_block_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ptc_block_matmul(x: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """x: (T, Q·k), u/v: (P, Q, k, k), s: (P, Q, k) → y: (T, P·k), x.dtype.

    fp32 or bf16 (all four alike), contiguous, on one device; accumulates
    in fp32 either way.
    """
    if x.dim() != 2 or u.dim() != 4 or v.shape != u.shape \
            or s.shape != u.shape[:3] or u.shape[2] != u.shape[3]:
        raise ValueError(f"ptc_block_matmul: bad shapes x{tuple(x.shape)} "
                         f"u{tuple(u.shape)} s{tuple(s.shape)} "
                         f"v{tuple(v.shape)}")
    p, q, k, _ = u.shape
    t = x.shape[0]
    if x.shape[1] != q * k:
        raise ValueError(f"ptc_block_matmul: x has {x.shape[1]} columns, "
                         f"the block grid needs Q·k = {q * k}")
    if len({a.dtype for a in (x, u, s, v)}) != 1 or x.dtype not in _DTYPES:
        raise TypeError("ptc_block_matmul: x, u, s, v must share one dtype, "
                        f"float32 or bfloat16; got {x.dtype}, {u.dtype}, "
                        f"{s.dtype}, {v.dtype}")
    if len({a.device for a in (x, u, s, v)}) != 1:
        raise ValueError("ptc_block_matmul: inputs lie on different devices")
    if not all(a.is_contiguous() for a in (x, u, s, v)):
        raise ValueError("ptc_block_matmul: inputs must be contiguous")
    if x.device.type == "cpu":
        return ptc_block_matmul_ref(x, u, s, v)
    if x.device.type != "cuda":
        raise ValueError(f"ptc_block_matmul: unsupported device {x.device}")
    if k > MAX_K:
        raise ValueError(f"ptc_block_matmul: k = {k} > {MAX_K}")
    y = torch.empty((t, p * k), dtype=x.dtype, device=x.device)
    if t == 0 or p == 0:
        return y.zero_()
    if -(-t // 128) > _MAX_ROW_TILES or p >= 2 ** 31:
        raise ValueError(f"ptc_block_matmul: grid too large (T={t}, P={p})")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib()(x.data_ptr(), u.data_ptr(), s.data_ptr(),
                        v.data_ptr(), y.data_ptr(), t, p, q, k,
                        _DTYPES[x.dtype], stream)
    build.check_status(NAME, status)
    build.launch_counts[NAME] += 1
    return y
