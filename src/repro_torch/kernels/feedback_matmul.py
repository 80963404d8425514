"""Block-masked error feedback ``dx_q = Σ_p 𝑃_W[q,p]·W_pqᵀ δy_p``: the wrapper.

Counterpart of ``repro/kernels/feedback_matmul.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches the hand-written
kernels in ``csrc/feedback_matmul.cu``: two pre-passes into scratch this
wrapper allocates (each kept block composed once, ``W̃_pq =
𝑃_W[q,p]·U_pq diag(s_pq) V*_pq``, and δy transposed so a row tile of one
block column is contiguous), then the register-tiled product that skips
masked blocks whole.  On a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.feedback_matmul_ref`).  :func:`plan` picks
the kernel's compiled k and its rows per lane.  Past k = 32 it launches
the wide route instead (counter ``feedback_matmul_wide``,
``csrc/ptc_wide.cu``): each block composed once by a batched block
product into a (P·k, Q·k) scratch scaled by its mask entry, then one
register-tiled product of 128 × 128 tiles that skips every reduction step
whose blocks the tile's q range all masked.  Both routes take fp32 or bf16
operands (all four alike; the mask fp32), widened on load.  bf16
operands at k = 64 and 128 take the tensor-core route instead
(``"wide_tc"``, counter ``feedback_matmul_wide_tc``,
``csrc/ptc_wide_tc.cu``): each kept block composed once by ``wgmma``,
transposed, into a bf16 (Q·k, P·k) scratch (U diag(s) scaled by its mask
entry in fp32 and rounded once to bf16, W̃ rounded once to bf16), then
``dx = δy W̃`` by ``wgmma`` from a TMA-fed ring into tiles of 256 rows and
one q block, over only the 64-row stages whose p block the tile's q block
keeps (:func:`repro_torch.kernels.ref.feedback_matmul_tc_ref` emulates its
roundings).  fp32 operands at k = 64 and 128 take the 3xTF32 route
(``"wide_3xtf32"``, counter ``feedback_matmul_wide_3xtf32``,
``csrc/ptc_wide_3xtf32.cu``): each kept block composed once, transposed,
by 3xTF32 ``wgmma`` into W̃ᵀ's tf32 hi and lo planes (2, Q·k, P·k) (U
diag(s) and its mask entry applied in fp32 before the split), δy split
once into its planes (2, T, P·k), both scratch this wrapper allocates,
then ``dx = δy W̃`` by 3×TF32 ``wgmma`` from a TMA-fed ring into 128 × 128
tiles over only the 32-column stages whose p block a q block of the tile
keeps (:func:`repro_torch.kernels.ref.feedback_matmul_3xtf32_ref` emulates
its arithmetic).  Other k stay on ``"wide"``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ptc_block_matmul import (LIB_3X, LIB_TC, LIB_WIDE, MAX_K, tc_lib,
                               tc_ok, tf32x3_lib, tf32x3_ok, wide_lib,
                               wide_plan)
from .ref import feedback_matmul_ref

__all__ = ["feedback_matmul", "route", "plan", "MAX_K", "ROUTES"]

NAME = "feedback_matmul"            # launch counter, k <= MAX_K
NAME_WIDE = "feedback_matmul_wide"  # launch counter, k > MAX_K
NAME_WIDE_TC = "feedback_matmul_wide_tc"  # launch counter, bf16 at TC_K
NAME_WIDE_3X = "feedback_matmul_wide_3xtf32"  # launch counter, fp32 at TC_K
ROUTES = {"narrow": NAME, "wide": NAME_WIDE, "wide_tc": NAME_WIDE_TC,
          "wide_3xtf32": NAME_WIDE_3X}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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


def route(k: int, dtype: torch.dtype | None = None) -> str:
    """``"narrow"`` (the k <= 32 kernel); past it, at k in
    :data:`~.ptc_block_matmul.TC_K`, ``"wide_tc"`` (the tensor cores) for
    bf16 operands and ``"wide_3xtf32"`` (the tensor cores in 3xTF32) for
    fp32 ones, else ``"wide"`` (other k, or no dtype given).  Reads
    nothing but its arguments."""
    if k <= MAX_K:
        return "narrow"
    if tc_ok(k, dtype):
        return "wide_tc"
    return "wide_3xtf32" if tf32x3_ok(k, dtype) else "wide"


def _lib():
    fn = build.library(NAME).feedback_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def feedback_matmul(dy: torch.Tensor, u: torch.Tensor, s: torch.Tensor,
                    v: torch.Tensor, mask: torch.Tensor, *,
                    force_route: str | None = None) -> torch.Tensor:
    """dy: (T, P·k), u/v: (P, Q, k, k), s: (P, Q, k), mask: (Q, P) scaled
    → dx: (T, Q·k), dy's dtype.

    dy, u, s, v all fp32 or all bf16, the mask fp32; contiguous, on one
    device; accumulated in fp32.  Blocks whose mask entry is 0 are skipped;
    a row of the mask with no kept block gives an exact zero.  Two runs
    give the same bits.  ``force_route`` overrides :func:`route` (for
    measuring and testing the routes; the callers in the port pass none).
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
    if len({a.dtype for a in (dy, u, s, v)}) != 1 \
            or dy.dtype not in _DTYPES or mask.dtype != torch.float32:
        raise TypeError("feedback_matmul: dy, u, s, v must share one dtype, "
                        "float32 or bfloat16, and the mask be float32; got "
                        f"{dy.dtype}, {u.dtype}, {s.dtype}, {v.dtype}, "
                        f"{mask.dtype}")
    if len({a.device for a in (dy, u, s, v, mask)}) != 1:
        raise ValueError("feedback_matmul: inputs lie on different devices")
    if not all(a.is_contiguous() for a in (dy, u, s, v, mask)):
        raise ValueError("feedback_matmul: inputs must be contiguous")
    which = force_route or route(k, dy.dtype)
    serves = {"narrow": k <= MAX_K, "wide": k > MAX_K,
              "wide_tc": tc_ok(k, dy.dtype),
              "wide_3xtf32": tf32x3_ok(k, dy.dtype)}
    if not serves.get(which, False):
        raise ValueError(f"feedback_matmul: no route {which!r} for k = {k}, "
                         f"{dy.dtype}")
    if force_route in ("wide_tc", "wide_3xtf32") \
            and dy.device.type != "cuda":
        raise ValueError(f"feedback_matmul: the {force_route} route runs on "
                         f"a CUDA tensor only, not on {dy.device}")
    if dy.device.type == "cpu":
        return feedback_matmul_ref(dy, u, s, v, mask)
    if dy.device.type != "cuda":
        raise ValueError(f"feedback_matmul: unsupported device {dy.device}")
    dx = torch.empty((t, q * k), dtype=dy.dtype, device=dy.device)
    if t == 0 or q == 0:
        return dx
    if which == "wide_3xtf32":
        if wide_plan(t, q * k, k).row_tiles > _MAX_ROW_TILES:
            raise ValueError(f"feedback_matmul: grid too large (T={t})")
        # δy's tf32 hi and lo; the kept blocks composed and transposed, hi
        # and lo (a masked block's tiles written only where read: zeros)
        dys = torch.empty((2, t, p * k), dtype=dy.dtype, device=dy.device)
        wt = torch.empty((2, q * k, p * k), dtype=dy.dtype, device=dy.device)
        with torch.cuda.device(dy.device):
            status = tf32x3_lib().ptc_3xtf32_feedback(
                dy.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                mask.data_ptr(), dys.data_ptr(), wt.data_ptr(), dx.data_ptr(),
                t, p, q, k, torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_3X, status)
        build.count_launch(NAME_WIDE_3X)
        return dx
    if which == "wide_tc":
        if wide_plan(t, q * k, k).row_tiles > _MAX_ROW_TILES:
            raise ValueError(f"feedback_matmul: grid too large (T={t})")
        # the kept blocks, composed and transposed (masked ones unwritten)
        wt = torch.empty((q * k, p * k), dtype=dy.dtype, device=dy.device)
        with torch.cuda.device(dy.device):
            status = tc_lib().ptc_tc_feedback(
                dy.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                mask.data_ptr(), wt.data_ptr(), dx.data_ptr(), t, p, q, k,
                torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_TC, status)
        build.count_launch(NAME_WIDE_TC)
        return dx
    if which == "wide":
        if wide_plan(t, q * k, k).row_tiles > _MAX_ROW_TILES:
            raise ValueError(f"feedback_matmul: grid too large (T={t})")
        w = torch.empty((p * k, q * k), dtype=torch.float32, device=dy.device)
        with torch.cuda.device(dy.device):
            status = wide_lib().ptc_wide_feedback(
                dy.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                mask.data_ptr(), w.data_ptr(), dx.data_ptr(), t, p, q, k,
                _DTYPES[dy.dtype], torch.cuda.current_stream().cuda_stream)
        build.check_status(LIB_WIDE, status)
        build.count_launch(NAME_WIDE)
        return dx
    kt, kp, rt = plan(t, k)
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
                        _DTYPES[dy.dtype], stream)
    build.check_status(NAME, status)
    build.count_launch(NAME)
    return dx
