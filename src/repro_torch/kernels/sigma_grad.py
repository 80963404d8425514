"""In-situ Σ-gradient ``ds_pq = Σ_t (U_pqᵀ δy_p) ⊙ (V*_pq x_q)``: the wrapper.

Counterpart of ``repro/kernels/sigma_grad.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernel in ``csrc/sigma_grad.cu``: the dense ``G = δyᵀx`` per tile of
(p-blocks × q-blocks), projected in the epilogue to ``ds_pq[i] = Σ_a
U[a,i] (G_pq V*_pqᵀ)[a,i]``; where the tiles cannot fill the card,
:func:`plan` splits T across CTAs and the kernel sums the splits' projected
partials in a fixed order.  Past k = 32 it launches the wide route
instead (counter ``sigma_grad_wide``, ``csrc/ptc_wide.cu``): the dense
``G = δyᵀx`` over all T rows by one register-tiled product of 128 × 128
tiles into an fp32 scratch, then each block projected by a batched block
product.  Both routes take fp32 or bf16 operands (all four alike),
widened on load; ds is fp32.  A column mask ``col`` scales δy's rows in
fp32: on the wide route as the kernel widens them; the k <= 32 ring
fetches fp32 rows by ``cp.async``, which cannot scale, so there the
wrapper forms ``col ⊙ δy`` in fp32 first (widening the other operands,
which changes none of their values).  bf16 operands at k = 64 and 128
take the tensor-core route instead (``"wide_tc"``, counter
``sigma_grad_wide_tc``, ``csrc/ptc_wide_tc.cu``): ``G = δyᵀx`` by
``wgmma`` from TMA-fed tiles over all T, projected in the same kernel
(G split into bf16 hi + lo, ``Uᵀ(G_hi + G_lo)`` by ``wgmma``, then
against V*); a column mask first splits ``col ⊙ δy``, formed in fp32,
into bf16 hi + lo, both reduced into one accumulator (lo only in the
64-row stages where it is not all zero: a scale on bf16's grid, as the
samplers' {0, 1} columns, costs one pass).  fp32 operands at k = 64
and 128 take the 3xTF32 route (``"wide_3xtf32"``, counter
``sigma_grad_wide_3xtf32``, ``csrc/ptc_wide_3xtf32.cu``): ``col ⊙ δy``
(formed in fp32) and x split into tf32 hi + lo and transposed into
T-contiguous planes this wrapper allocates, ``G = δyᵀx`` by ``wgmma`` as
lo·hi + hi·lo + hi·hi over all T, projected in the same kernel in fp32
(:func:`repro_torch.kernels.ref.sigma_grad_3xtf32_ref` emulates it).  On
a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.sigma_grad_ref`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ptc_block_matmul import (LIB_3X, LIB_TC, LIB_WIDE, MAX_K, TF32X3_TILE,
                               kernel_k, tc_lib, tc_ok, tf32x3_lib,
                               tf32x3_ok, wide_lib, wide_plan, wide_route)
from .ref import sigma_grad_ref

__all__ = ["sigma_grad", "route", "plan", "Plan", "MAX_K", "ROUTES"]

NAME = "sigma_grad"                 # launch counter, k <= MAX_K
NAME_WIDE = "sigma_grad_wide"       # launch counter, k > MAX_K
NAME_WIDE_TC = "sigma_grad_wide_tc"  # launch counter, bf16 at k in TC_K
NAME_WIDE_3X = "sigma_grad_wide_3xtf32"  # launch counter, fp32 at TC_K
ROUTES = {"narrow": NAME, "wide": NAME_WIDE, "wide_tc": NAME_WIDE_TC,
          "wide_3xtf32": NAME_WIDE_3X}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    CTAs per SM, each of at least 256 rows.  k past :data:`MAX_K` has no
    plan here (the wide route)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sigma_grad: k = {k} outside 1..{MAX_K}")
    kt = kernel_k(k)
    mp, nq = _TILE[kt]
    tiles = -(-p // mp) * -(-q // nq)
    splits = 1
    if 0 < tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), -(-t // _MIN_CHUNK_ROWS)))
    per = -(-t // splits)
    chunk = max(_BK, -(-per // _BK) * _BK)
    return Plan(kt, mp, nq, max(1, -(-t // chunk)), chunk)


def route(k: int, dtype: torch.dtype | None = None) -> str:
    """``"narrow"`` (the k <= 32 kernel); past it
    :func:`~.ptc_block_matmul.wide_route`: ``"wide_tc"`` (bf16) and
    ``"wide_3xtf32"`` (fp32) at k in :data:`~.ptc_block_matmul.TC_K`, else
    ``"wide"`` (other k, or no dtype given).  Reads nothing but its
    arguments."""
    return "narrow" if k <= MAX_K else wide_route(k, dtype)


def _lib():
    """The loaded ``sigma_grad`` library (the k <= 32 kernel, and
    ``sigma_grad_tile``, its tile by k: p-blocks, q-blocks, rows a stage)."""
    lib = build.library(NAME)
    if lib.sigma_grad.argtypes is None:
        lib.sigma_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        lib.sigma_grad.restype = ctypes.c_int
        lib.sigma_grad_tile.argtypes = [ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
        lib.sigma_grad_tile.restype = ctypes.c_int
    return lib


def sigma_grad(dy: torch.Tensor, x: torch.Tensor, u: torch.Tensor,
               v: torch.Tensor, col: torch.Tensor | None = None, *,
               force_route: str | None = None,
               force_plan: Plan | None = None) -> torch.Tensor:
    """dy: (T, P·k), x: (T, Q·k), u/v: (P, Q, k, k), col: (T,) fp32 column
    scale or None → ds: (P, Q, k) fp32, the Σ-gradient of ``col ⊙ δy``.

    dy, x, u, v all fp32 or all bf16, contiguous, on one device;
    accumulated in fp32, the column scale applied in fp32.  Two runs give
    the same bits.
    ``force_route`` and ``force_plan`` override :func:`route` and
    :func:`plan` (for measuring and testing the routes and splits; the
    callers in the port pass neither).
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
    if len({a.dtype for a in (dy, x, u, v)}) != 1 or dy.dtype not in _DTYPES:
        raise TypeError("sigma_grad: dy, x, u, v must share one dtype, "
                        f"float32 or bfloat16; got {dy.dtype}, {x.dtype}, "
                        f"{u.dtype}, {v.dtype}")
    if col is not None and (col.shape != (t,) or col.dtype != torch.float32):
        raise ValueError(f"sigma_grad: col must be ({t},) float32, got "
                         f"{tuple(col.shape)} {col.dtype}")
    ins = (dy, x, u, v) if col is None else (dy, x, u, v, col)
    if len({a.device for a in ins}) != 1:
        raise ValueError("sigma_grad: inputs lie on different devices")
    if not all(a.is_contiguous() for a in ins):
        raise ValueError("sigma_grad: inputs must be contiguous")
    which = force_route or route(k, dy.dtype)
    serves = {"narrow": k <= MAX_K, "wide": k > MAX_K,
              "wide_tc": tc_ok(k, dy.dtype),
              "wide_3xtf32": tf32x3_ok(k, dy.dtype)}
    if not serves.get(which, False):
        raise ValueError(f"sigma_grad: no route {which!r} for k = {k}, "
                         f"{dy.dtype}")
    if force_route in ("wide_tc", "wide_3xtf32") \
            and dy.device.type != "cuda":
        raise ValueError(f"sigma_grad: the {force_route} route runs on a "
                         f"CUDA tensor only, not on {dy.device}")
    if dy.device.type == "cpu":
        return sigma_grad_ref(dy, x, u, v, col)
    if dy.device.type != "cuda":
        raise ValueError(f"sigma_grad: unsupported device {dy.device}")
    ds = torch.empty((p, q, k), dtype=torch.float32, device=dy.device)
    if t == 0 or p * q == 0:
        return ds.zero_()
    if which == "wide_3xtf32":
        if wide_plan(p * k, q * k, k).row_tiles > _MAX_GRID:
            raise ValueError(f"sigma_grad: grid too large (P={p}, k={k})")
        # col ⊙ δy's and x's tf32 hi and lo, transposed: T-contiguous rows
        # of T rounded up to a stage, zero-padded by the kernel's first pass
        tp = -(-t // TF32X3_TILE[2]) * TF32X3_TILE[2]
        a = torch.empty((2, p * k, tp), dtype=dy.dtype, device=dy.device)
        b = torch.empty((2, q * k, tp), dtype=dy.dtype, device=dy.device)
        with torch.cuda.device(dy.device):
            status = tf32x3_lib().ptc_3xtf32_sigma(
                dy.data_ptr(), x.data_ptr(), u.data_ptr(), v.data_ptr(),
                0 if col is None else col.data_ptr(), a.data_ptr(),
                b.data_ptr(), ds.data_ptr(), t, p, q, k,
                torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_3X, status)
        build.count_launch(NAME_WIDE_3X)
        return ds
    if which == "wide_tc":
        if wide_plan(p * k, q * k, k).row_tiles > _MAX_GRID:
            raise ValueError(f"sigma_grad: grid too large (P={p}, k={k})")
        # col ⊙ δy's bf16 hi and lo, formed by the kernel's first pass,
        # and which 64-row stages of lo are not all zero
        split = torch.empty((2, t, p * k) if col is not None else (0,),
                            dtype=dy.dtype, device=dy.device)
        live = torch.empty((-(-t // 64),) if col is not None else (0,),
                           dtype=torch.int32, device=dy.device)
        with torch.cuda.device(dy.device):
            status = tc_lib().ptc_tc_sigma(
                dy.data_ptr(), 0, x.data_ptr(), u.data_ptr(), v.data_ptr(),
                0 if col is None else col.data_ptr(), split.data_ptr(),
                live.data_ptr(), ds.data_ptr(), t, p, q, k,
                torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_TC, status)
        build.count_launch(NAME_WIDE_TC)
        return ds
    if which == "wide":
        if wide_plan(p * k, q * k, k).row_tiles > _MAX_GRID:
            raise ValueError(f"sigma_grad: grid too large (P={p}, k={k})")
        g = torch.empty((p * k, q * k), dtype=torch.float32, device=dy.device)
        with torch.cuda.device(dy.device):
            status = wide_lib().ptc_wide_sigma(
                dy.data_ptr(), x.data_ptr(), u.data_ptr(), v.data_ptr(),
                0 if col is None else col.data_ptr(), g.data_ptr(),
                ds.data_ptr(), t, p, q, k, _DTYPES[dy.dtype],
                torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_WIDE, status)
        build.count_launch(NAME_WIDE)
        return ds
    if col is not None:
        dy = dy.float() * col[:, None]
        x, u, v = x.float(), u.float(), v.float()
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
                                   pl.splits, _DTYPES[dy.dtype], stream)
    build.check_status(NAME, status)
    build.count_launch(NAME)
    return ds
