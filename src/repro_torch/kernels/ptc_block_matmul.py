"""Blocked PTC forward ``y_p = Σ_q U_pq(Σ_pq ⊙ (V*_pq x_q))``: the wrapper.

Counterpart of ``repro/kernels/ptc_block_matmul.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches one of the two
routes of ``csrc/ptc_block_matmul.cu``, picked by :func:`route` from the
shapes alone, each counting its launches under its own name:

* ``"product"`` (counter ``ptc_block_matmul``): each block composed once,
  ``W_pq = U_pq diag(s_pq) V*_pq``, into scratch this wrapper allocates, then
  the register-tiled fp32 product ``y = x Wᵀ``, its K range split across CTAs
  where the output tiles cannot fill the card (:func:`plan`), and the splits
  added in a fixed order;
* ``"per_block"`` (counter ``ptc_block_matmul_perblock``): Q = 1 and few
  rows, as the IC/PM probes send (the eye through every block), where the
  output is the composed blocks themselves and the work is bytes;
* ``"wide"`` (counter ``ptc_block_matmul_wide``, ``csrc/ptc_wide.cu``):
  every k > 32 (k = 128 in every LM config), whatever T and Q: each block
  composed once by a batched block product into a (P·k, Q·k) scratch, the
  same layout the feedback composes, then one register-tiled fp32 product
  of 128 × 128 output tiles that reads it transposed
  (:data:`WIDE_TILE`, :func:`wide_plan`);
* ``"wide_tc"`` (counter ``ptc_block_matmul_wide_tc``,
  ``csrc/ptc_wide_tc.cu``): bf16 operands at k in :data:`TC_K` (64, 128),
  on the tensor cores: each block composed once by ``wgmma`` into a bf16
  (P·k, Q·k) scratch (U diag(s) and W each rounded once to bf16), then
  ``y = x Wᵀ`` by ``wgmma`` from a TMA-fed ring into 128 × 256 output
  tiles (:data:`TC_TILE`);
* ``"wide_3xtf32"`` (counter ``ptc_block_matmul_wide_3xtf32``,
  ``csrc/ptc_wide_3xtf32.cu``): fp32 operands at k in :data:`TC_K`, on
  the tensor cores in 3xTF32 (each operand split into tf32 hi + lo, the
  product taken as lo·hi + hi·lo + hi·hi in fp32;
  :func:`repro_torch.kernels.ref.ptc_block_matmul_3xtf32_ref` emulates
  it): each block composed once by ``wgmma`` into W's tf32 hi and lo
  planes (2, P·k, Q·k), x split once into its planes (2, T, Q·k), both
  scratch this wrapper allocates, then ``y = x Wᵀ`` by ``wgmma`` from a
  TMA-fed ring into 128 × 128 output tiles (:data:`TF32X3_TILE`).
  Other k stay on ``"wide"``.

On a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.ptc_block_matmul_ref`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ref import ptc_block_matmul_ref

__all__ = ["ptc_block_matmul", "route", "plan", "Plan", "kernel_k",
           "wide_plan", "WidePlan", "wide_route", "wide_lib", "tc_lib", "tc_ok",
           "tf32x3_lib", "tf32x3_ok", "MAX_K", "PER_BLOCK_MAX_T", "ROUTES",
           "K_STAGE", "WIDE_TILE", "TC_K", "TC_TILE", "TF32X3_TILE"]

LIB = "ptc_block_matmul"
LIB_WIDE = "ptc_wide"                     # the k > MAX_K routes of all three
LIB_TC = "ptc_wide_tc"                    # the tensor-core routes of all three
LIB_3X = "ptc_wide_3xtf32"                # the fp32 tensor-core routes
NAME = "ptc_block_matmul"                 # launch counter, product route
NAME_PER_BLOCK = "ptc_block_matmul_perblock"
NAME_WIDE = "ptc_block_matmul_wide"
NAME_WIDE_TC = "ptc_block_matmul_wide_tc"
NAME_WIDE_3X = "ptc_block_matmul_wide_3xtf32"
ROUTES = {"product": NAME, "per_block": NAME_PER_BLOCK, "wide": NAME_WIDE,
          "wide_tc": NAME_WIDE_TC, "wide_3xtf32": NAME_WIDE_3X}
MAX_K = 32                      # the widest block of the k <= 32 kernels
# the block sizes of the tensor-core routes (bf16, and fp32 in 3xTF32): a
# 128 × 128 tile of G is one block at k = 128 and 2 × 2 blocks at k = 64
TC_K = (64, 128)
# the tensor-core forward product's CTA output tile (rows, columns) and
# reduction columns a stage (csrc/ptc_wide_tc.cu; the kernel reports its
# own by ptc_tc_tile); its rows are the wide route's, so one grid check
# (wide_plan) serves both
TC_TILE = (128, 256, 64)
# the 3xTF32 product's CTA output tile (rows, columns) and reduction
# columns a stage (csrc/ptc_wide_3xtf32.cu; reported by ptc_3xtf32_tile);
# its rows are the wide route's too
TF32X3_TILE = (128, 128, 32)
# the wide kernels' CTA output tile (rows, columns) and reduction steps a
# stage (csrc/ptc_wide.cu; the kernel reports its own by ptc_wide_tile)
WIDE_TILE = (128, 128, 16)
# the per-block route takes Q = 1 up to this many rows.  Measured on an
# H100 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py's crossover line), ms
# per call, per-block against product: P = 57: T 64 0.0111 / 0.0178, T 128
# 0.0176 / 0.0244, T 256 0.0310 / 0.0244, T 1024 0.1107 / 0.0279; P =
# 25,992: per-block faster at every T to 1024 (0.4549 / 2.7372).  Its grid
# spans P alone, so the smaller P sets the crossover: 128, the last T where
# it won at both.
PER_BLOCK_MAX_T = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_K = (4, 8, 9, 16, 32)
K_STAGE = 32                    # K columns per ring stage of the product
_MAX_GRID_Y = 65535


def kernel_k(k: int) -> int:
    """The k the kernels are compiled for: the least of 4, 8, 9, 16, 32
    that holds k; past 32, k itself (the wide kernels take it at run
    time)."""
    if k < 1:
        raise ValueError(f"ptc_block_matmul: k = {k} < 1")
    return next((c for c in _KERNEL_K if c >= k), k)


def tc_ok(k: int, dtype: torch.dtype | None) -> bool:
    """Whether the tensor-core routes take blocks of size k in ``dtype``:
    bf16 operands at k in :data:`TC_K`."""
    return dtype == torch.bfloat16 and k in TC_K


def tf32x3_ok(k: int, dtype: torch.dtype | None) -> bool:
    """Whether the 3xTF32 routes take blocks of size k in ``dtype``: fp32
    operands at k in :data:`TC_K`."""
    return dtype == torch.float32 and k in TC_K


def wide_route(k: int, dtype: torch.dtype | None) -> str:
    """The route past :data:`MAX_K` of the forward and the Σ-gradient:
    ``"wide_tc"`` for bf16 operands at k in :data:`TC_K`,
    ``"wide_3xtf32"`` for fp32 ones there, else ``"wide"`` (other k, or
    no dtype given)."""
    if tc_ok(k, dtype):
        return "wide_tc"
    return "wide_3xtf32" if tf32x3_ok(k, dtype) else "wide"


def route(t: int, p: int, q: int, k: int,
          dtype: torch.dtype | None = None) -> str:
    """Past :data:`MAX_K`: :func:`wide_route` (``"wide_tc"`` for bf16 and
    ``"wide_3xtf32"`` for fp32 operands at k in :data:`TC_K`, else
    ``"wide"``); up to it ``"per_block"`` for one input block (Q = 1) and
    at most :data:`PER_BLOCK_MAX_T` rows, ``"product"`` for every other
    shape.  The rule reads nothing but its arguments."""
    if k > MAX_K:
        return wide_route(k, dtype)
    return "per_block" if q == 1 and t <= PER_BLOCK_MAX_T else "product"


class WidePlan(NamedTuple):
    """The wide kernels' grids: output tiles of the product along its rows
    and columns, and each block's tiles along a side (the batched block
    products: compose and project)."""
    row_tiles: int
    col_tiles: int
    block_tiles: int


def wide_plan(rows: int, cols: int, k: int) -> WidePlan:
    """The tiling of a wide product with a (rows, cols) output over blocks
    of size k: :data:`WIDE_TILE` tiles, the last of each side ragged (the
    kernels size their grids the same way; the wrappers check the row
    tiles against the grid's limit)."""
    bm, bn, _ = WIDE_TILE
    return WidePlan(-(-rows // bm), -(-cols // bn), -(-k // bm))


def wide_lib():
    """The loaded ``ptc_wide`` library (the k > 32 routes of
    ``ptc_block_matmul``, ``sigma_grad`` and ``feedback_matmul``)."""
    lib = build.library(LIB_WIDE)
    if lib.ptc_wide_forward.argtypes is None:
        lib.ptc_wide_forward.argtypes = \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptc_wide_sigma.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptc_wide_feedback.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ptc_wide_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.ptc_wide_forward, lib.ptc_wide_sigma,
                   lib.ptc_wide_feedback, lib.ptc_wide_tile):
            fn.restype = ctypes.c_int
    return lib


def tc_lib():
    """The loaded ``ptc_wide_tc`` library (the tensor-core routes of
    ``ptc_block_matmul``, ``sigma_grad`` and ``feedback_matmul``)."""
    lib = build.library(LIB_TC)
    if lib.ptc_tc_forward.argtypes is None:
        lib.ptc_tc_forward.argtypes = \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_tc_sigma.argtypes = \
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_tc_feedback.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_tc_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.ptc_tc_forward, lib.ptc_tc_sigma, lib.ptc_tc_feedback,
                   lib.ptc_tc_tile):
            fn.restype = ctypes.c_int
    return lib


def tf32x3_lib():
    """The loaded ``ptc_wide_3xtf32`` library (the 3xTF32 routes of
    ``ptc_block_matmul``, ``sigma_grad`` and ``feedback_matmul``)."""
    lib = build.library(LIB_3X)
    if lib.ptc_3xtf32_forward.argtypes is None:
        lib.ptc_3xtf32_forward.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_3xtf32_sigma.argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_3xtf32_feedback.argtypes = \
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_3xtf32_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for fn in (lib.ptc_3xtf32_forward, lib.ptc_3xtf32_sigma,
                   lib.ptc_3xtf32_feedback, lib.ptc_3xtf32_tile):
            fn.restype = ctypes.c_int
    return lib


class Plan(NamedTuple):
    """The product route's launch: compiled k, warps along N (1 or 2), rows
    and output blocks per CTA, the K splits and the columns in each."""
    kt: int
    wn: int
    bm: int
    nblk: int
    splits: int
    kc: int

    @property
    def kp(self) -> int:
        """The composed scratch's width per block (kt to a multiple of 4)."""
        return -(-self.kt // 4) * 4


def plan(t: int, p: int, q: int, k: int, sms: int = 132) -> Plan:
    """The product route's tiling for x (T, Q·k) through a P × Q grid.

    A CTA owns ``bm`` rows × ``nblk`` output blocks: 256 rows × 8 blocks
    where P is at most 8 blocks (so VGG-8's P = 8 convolutions waste no
    column), else 128 rows × 16 blocks (k <= 9; 8 of 16, 4 of 32).  Where
    the output tiles would leave more than half of the ``sms`` SMs idle,
    the K range (Q·k columns) is cut into ``splits`` of ``kc`` columns (a
    multiple of :data:`K_STAGE`), about one CTA per SM: on an H100 that
    beat two per SM at every VGG-8 shape and at serve W1 (the partials'
    round trip and the second pass cost more than the second CTA gains;
    PERF.md).  k past :data:`MAX_K` has no product plan (the wide route)."""
    if k > MAX_K:
        raise ValueError(f"ptc_block_matmul: the product route takes k <= "
                         f"{MAX_K}, not {k}")
    kt = kernel_k(k)
    wb = 8 if kt <= 9 else (4 if kt == 16 else 2)
    wn = 1 if p <= wb else 2
    bm, nblk = 256 // wn, wn * wb
    tiles = -(-t // bm) * -(-p // nblk)
    ktiles = max(1, -(-(q * k) // K_STAGE))
    splits = max(1, min(sms // max(tiles, 1), ktiles))
    kc_tiles = -(-ktiles // splits)
    return Plan(kt, wn, bm, nblk, -(-ktiles // kc_tiles), kc_tiles * K_STAGE)


def _fns():
    lib = build.library(LIB)
    if lib.ptc_block_matmul_product.argtypes is None:
        lib.ptc_block_matmul_product.argtypes = \
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ptc_block_matmul_product.restype = ctypes.c_int
        lib.ptc_block_matmul_perblock.argtypes = \
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.ptc_block_matmul_perblock.restype = ctypes.c_int
    return lib


def ptc_block_matmul(x: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                     v: torch.Tensor, *, force_route: str | None = None,
                     force_plan: Plan | None = None) -> torch.Tensor:
    """x: (T, Q·k), u/v: (P, Q, k, k), s: (P, Q, k) → y: (T, P·k), x.dtype.

    fp32 or bf16 (all four alike), contiguous, on one device; accumulates
    in fp32 either way.  ``force_route`` and ``force_plan`` override
    :func:`route` and :func:`plan` (for measuring and testing the routes
    and splits; the callers in the port pass neither).
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
    which = force_route or route(t, p, q, k, x.dtype)
    serves = {"product": k <= MAX_K, "per_block": k <= MAX_K and q == 1,
              "wide": k > MAX_K, "wide_tc": tc_ok(k, x.dtype),
              "wide_3xtf32": tf32x3_ok(k, x.dtype)}
    if not serves.get(which, False):
        raise ValueError(f"ptc_block_matmul: no route {which!r} for Q = {q},"
                         f" k = {k}, {x.dtype}")
    if force_route in ("wide_tc", "wide_3xtf32") \
            and x.device.type != "cuda":
        raise ValueError(f"ptc_block_matmul: the {force_route} route runs "
                         f"on a CUDA tensor only, not on {x.device}")
    if x.device.type == "cpu":
        return ptc_block_matmul_ref(x, u, s, v)
    if x.device.type != "cuda":
        raise ValueError(f"ptc_block_matmul: unsupported device {x.device}")
    y = torch.empty((t, p * k), dtype=x.dtype, device=x.device)
    if t == 0 or p == 0 or q == 0:
        return y.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if which == "wide_3xtf32":
            lib = LIB_3X
            if wide_plan(t, p * k, k).row_tiles > _MAX_GRID_Y:
                raise ValueError(f"ptc_block_matmul: grid too large (T={t})")
            # x's and W's tf32 hi and lo planes
            xs = torch.empty((2, t, q * k), dtype=x.dtype, device=x.device)
            w = torch.empty((2, p * k, q * k), dtype=x.dtype, device=x.device)
            status = tf32x3_lib().ptc_3xtf32_forward(
                x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                xs.data_ptr(), w.data_ptr(), y.data_ptr(), t, p, q, k, stream)
        elif which == "wide_tc":
            lib = LIB_TC
            if wide_plan(t, p * k, k).row_tiles > _MAX_GRID_Y:
                raise ValueError(f"ptc_block_matmul: grid too large (T={t})")
            w = torch.empty((p * k, q * k), dtype=x.dtype, device=x.device)
            status = tc_lib().ptc_tc_forward(
                x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                w.data_ptr(), y.data_ptr(), t, p, q, k, stream)
        elif which == "wide":
            lib = LIB_WIDE
            if wide_plan(t, p * k, k).row_tiles > _MAX_GRID_Y:
                raise ValueError(f"ptc_block_matmul: grid too large (T={t})")
            w = torch.empty((p * k, q * k), dtype=torch.float32,
                            device=x.device)
            status = wide_lib().ptc_wide_forward(
                x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                w.data_ptr(), y.data_ptr(), t, p, q, k, _DTYPES[x.dtype],
                stream)
        elif which == "per_block":
            lib = LIB
            status = _fns().ptc_block_matmul_perblock(
                x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                y.data_ptr(), t, p, k, _DTYPES[x.dtype], stream)
        else:
            lib = LIB
            pl = force_plan or plan(t, p, q, k, build.sm_count(x.device))
            if max(-(-t // pl.bm), pl.splits, q) > _MAX_GRID_Y:
                raise ValueError(f"ptc_block_matmul: grid too large "
                                 f"(T={t}, Q={q})")
            wt = torch.empty((q * k, p * pl.kp), dtype=torch.float32,
                             device=x.device)
            part = torch.empty((pl.splits, t, p * k) if pl.splits > 1
                               else (0,), dtype=torch.float32,
                               device=x.device)
            status = _fns().ptc_block_matmul_product(
                x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                wt.data_ptr(), part.data_ptr(), y.data_ptr(), t, p, q, k,
                _DTYPES[x.dtype], pl.wn, pl.kc, pl.splits, stream)
    build.check_status(lib, status)
    build.count_launch(ROUTES[which])
    return y
