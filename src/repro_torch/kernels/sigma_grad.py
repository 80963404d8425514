"""In-situ Σ-gradient ``ds_pq = Σ_t (U_pqᵀ δy_p) ⊙ (V*_pq x_q)``: the wrapper.

Counterpart of ``repro/kernels/sigma_grad.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/sigma_grad.cu``: the dense ``G = δyᵀx`` per tile of
(p-blocks × q-blocks), projected in the epilogue to ``ds_pq[i] = Σ_a
U[a,i] (G_pq V*_pqᵀ)[a,i]``; where the tiles cannot fill the card,
:func:`plan` splits T across CTAs and the kernel sums the splits' projected
partials in a fixed order.  On a CPU tensor it runs the plain PyTorch
version (:func:`repro_torch.kernels.ref.sigma_grad_ref`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ptc_block_matmul import kernel_k
from .ref import sigma_grad_ref

__all__ = ["sigma_grad", "plan", "Plan", "MAX_K"]

NAME = "sigma_grad"
MAX_K = 32
# (p-blocks, q-blocks) of a CTA's G tile by compiled k: 128 threads, each a
# 9 x 9 (k = 9) or 8 x 8 tile of G
_TILE = {4: (16, 32), 8: (8, 16), 9: (8, 16), 16: (4, 8), 32: (2, 4)}
_BK = 16                        # rows per ring stage
_MIN_CHUNK_ROWS = 256           # a T split spans at least 16 stages
_MAX_GRID = 65535


class Plan(NamedTuple):
    """The launch: compiled k, blocks per CTA tile (p, q), T splits and the
    rows in each."""
    kt: int
    mp: int
    nq: int
    splits: int
    chunk_rows: int


def plan(t: int, p: int, q: int, k: int, sms: int = 132) -> Plan:
    """The tiling of G = δyᵀx for T rows over a P × Q block grid.

    A CTA owns ``mp`` × ``nq`` blocks of G (8 × 16 at k = 9) over a chunk
    of ``chunk_rows`` rows (a multiple of 16).  Where the tiles are fewer
    than the ``sms`` SMs, T is cut into ``splits`` chunks, enough for two
    CTAs per SM, each of at least 256 rows."""
    kt = kernel_k(k)
    mp, nq = _TILE[kt]
    tiles = -(-p // mp) * -(-q // nq)
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), -(-t // _MIN_CHUNK_ROWS)))
    per = -(-t // splits)
    chunk = max(_BK, -(-per // _BK) * _BK)
    return Plan(kt, mp, nq, max(1, -(-t // chunk)), chunk)


def _lib():
    lib = build.library(NAME)
    if lib.sigma_grad.argtypes is None:
        lib.sigma_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        lib.sigma_grad.restype = ctypes.c_int
    return lib


def sigma_grad(dy: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor, *, force_plan: Plan | None = None
               ) -> torch.Tensor:
    """dy: (T, P·k), x: (T, Q·k), u/v: (P, Q, k, k) → ds: (P, Q, k) fp32.

    All fp32, contiguous, on one device.  Two runs give the same bits.
    ``force_plan`` overrides :func:`plan` (for testing the splits; the
    callers in the port pass none).
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
    kernel_k(k)
    ds = torch.empty((p, q, k), dtype=torch.float32, device=dy.device)
    if t == 0 or p * q == 0:
        return ds.zero_()
    pl = force_plan or plan(t, p, q, k, build.sm_count(dy.device))
    if -(-p // pl.mp) > _MAX_GRID or pl.splits > _MAX_GRID \
            or p * q * k >= 2 ** 31:
        raise ValueError(f"sigma_grad: grid too large (P={p}, Q={q})")
    part = torch.empty((pl.splits, p, q, k) if pl.splits > 1 else (0,),
                       dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().sigma_grad(dy.data_ptr(), x.data_ptr(), u.data_ptr(),
                                   v.data_ptr(), part.data_ptr(),
                                   ds.data_ptr(), t, p, q, k, pl.chunk_rows,
                                   pl.splits, stream)
    build.check_status(NAME, status)
    build.launch_counts[NAME] += 1
    return ds
