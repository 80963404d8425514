"""In-situ Σ-gradient ``ds_pq = Σ_t (U_pqᵀ δy_p) ⊙ (V*_pq x_q)``: the wrapper.

Counterpart of ``repro/kernels/sigma_grad.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/sigma_grad.cu``; on a CPU tensor it runs the plain
PyTorch version (:func:`repro_torch.kernels.ref.sigma_grad_ref`).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import sigma_grad_ref

__all__ = ["sigma_grad", "MAX_K"]

NAME = "sigma_grad"
MAX_K = 32


def _lib():
    lib = build.library(NAME)
    if lib.sigma_grad.argtypes is None:
        lib.sigma_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.sigma_grad.restype = ctypes.c_int
        lib.sigma_grad_chunks.argtypes = [ctypes.c_int] * 4
        lib.sigma_grad_chunks.restype = ctypes.c_int
    return lib


def sigma_grad(dy: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """dy: (T, P·k), x: (T, Q·k), u/v: (P, Q, k, k) → ds: (P, Q, k) fp32.

    All fp32, contiguous, on one device.  The kernel splits T across
    CTAs and sums the chunks in a fixed order: two runs give the same bits.
    """
    if dy.dim() != 2 or x.dim() != 2 or u.dim() != 4 or v.shape != u.shape \
            or u.shape[2] != u.shape[3] or x.shape[0] != dy.shape[0]:
        raise ValueError(f"sigma_grad: bad shapes dy{tuple(dy.shape)} "
                         f"x{tuple(x.shape)} u{tuple(u.shape)} "
                         f"v{tuple(v.shape)}")
    p, q, k, _ = u.shape
    t = dy.shape[0]
    if dy.shape[1] != p * k or x.shape[1] != q * k:
        raise ValueError(f"sigma_grad: dy has {dy.shape[1]} and x "
                         f"{x.shape[1]} columns, the block grid needs "
                         f"P·k = {p * k} and Q·k = {q * k}")
    if any(a.dtype != torch.float32 for a in (dy, x, u, v)):
        raise TypeError("sigma_grad: dy, x, u, v must be float32; got "
                        f"{dy.dtype}, {x.dtype}, {u.dtype}, {v.dtype}")
    if len({a.device for a in (dy, x, u, v)}) != 1:
        raise ValueError("sigma_grad: inputs lie on different devices")
    if not all(a.is_contiguous() for a in (dy, x, u, v)):
        raise ValueError("sigma_grad: inputs must be contiguous")
    if dy.device.type == "cpu":
        return sigma_grad_ref(dy, x, u, v)
    if dy.device.type != "cuda":
        raise ValueError(f"sigma_grad: unsupported device {dy.device}")
    if k > MAX_K:
        raise ValueError(f"sigma_grad: k = {k} > {MAX_K}")
    ds = torch.empty((p, q, k), dtype=torch.float32, device=dy.device)
    if t == 0 or p * q == 0:
        return ds.zero_()
    if p * q >= 2 ** 31:
        raise ValueError(f"sigma_grad: grid too large (P={p}, Q={q})")
    lib = _lib()
    chunks = lib.sigma_grad_chunks(t, p, q, k)
    part = torch.empty((chunks, p, q, k) if chunks > 1 else (0,),
                       dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.sigma_grad(dy.data_ptr(), x.data_ptr(), u.data_ptr(),
                                v.data_ptr(), part.data_ptr(), ds.data_ptr(),
                                t, p, q, k, chunks, stream)
    build.check_status(NAME, status)
    build.launch_counts[NAME] += 1
    return ds
