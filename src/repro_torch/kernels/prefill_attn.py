"""Chunked paged-prefill attention for the serving gateway: the wrapper.

Counterpart of ``repro/kernels/prefill_attn.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor it launches one of two
hand-written kernels, chosen by :func:`route` from the dtypes and the head
dim alone: bf16 q over bf16 K/V at head dim 64 or 128 goes to the
tensor-core kernel (``csrc/prefill_attn_tc.cu``: wgmma, TMA-fed K/V
tiles), every other pair — fp32/fp32, fp32 q over bf16 K/V, other head
dims — to the CUDA-core kernel (``csrc/prefill_attn.cu``), because the
tensor cores would take fp32 products in TF32.  Each route counts its
launches under its own name.  On a CPU tensor it runs the plain PyTorch
version (:func:`repro_torch.kernels.ref.prefill_attention_ref`).

A causal chunk of C query tokens per slot, already rope'd at absolute
positions ``lens[b] + c``, attends over the slot's page-assembled view
with the chunk's own K/V rows spliced in, with GQA, an optional sliding
window and an optional logit soft-cap.  The reference's online softmax
runs over KV blocks of ``blk`` keys; both kernels walk the view in tiles
of their own (64 keys; 32 on the CUDA cores past head dim 128), with the
same masking discipline (finite floor ``NEG_INF`` before the max,
probabilities zeroed by the mask, so a fully masked tile adds exactly
+0.0).  ``blk`` changes only the order of the sums, never the function,
and neither kernel reads it.

Q·K products accumulate in fp32 from the inputs as given.  The Pallas
body rounds bf16 logits to bf16 before its fp32 cast; the port does not
copy that rounding, so at bf16 inputs it differs from the reference by
that rounding, and at fp32 inputs both agree to 2e-5.  The tensor-core
kernel rounds the probabilities to bf16 for the P·V product (the
denominator sums them in fp32).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import prefill_attention_ref

__all__ = ["prefill_attention", "route", "MAX_HEAD_DIM", "TC_HEAD_DIMS"]

LIB = "prefill_attn"                       # the CUDA-core kernel
LIB_TC = "prefill_attn_tc"                 # the tensor-core kernel
NAME = "prefill_attention"                 # launch counter, tensor cores
NAME_CUDA_CORES = "prefill_attention_cudacore"
MAX_HEAD_DIM = 256
TC_HEAD_DIMS = (64, 128)
_DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.bfloat16))    # (q, k and v)


def route(q_dtype: torch.dtype, kv_dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that serves a call: ``"tensor_cores"`` for bf16 q over
    bf16 K/V at a head dim in :data:`TC_HEAD_DIMS`, ``"cuda_cores"`` for
    every other pair.  The rule reads nothing but its arguments: neither
    route is ever taken because the other failed."""
    if q_dtype == kv_dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def _fn():
    fn = build.library(LIB).prefill_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _fn_tc():
    fn = build.library(LIB_TC).prefill_attention_tc
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def prefill_attention(lens: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, *, blk: int | None = None,
                      window: int | None = None,
                      cap: float | None = None) -> torch.Tensor:
    """lens: (B,) int32 tokens already cached per slot; q: (B, C, H, Dh);
    k, v: (B, S, Hkv, Dh) views with the chunk's rows spliced in at
    ``lens[b]..lens[b]+C-1``.  ``blk`` must divide S (None: the whole
    view); ``window``: sliding window; ``cap``: logit soft-cap.  Returns
    (B, C, H, Dh) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or lens.shape != (q.shape[0],):
        raise ValueError(f"prefill_attention: bad shapes lens"
                         f"{tuple(lens.shape)} q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    b, c, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"prefill_attention: {h} query heads over {hkv} "
                         f"KV heads")
    blk = s if blk is None else int(blk)
    if blk <= 0 or s % blk:
        raise ValueError(f"kv view length {s} not divisible by block {blk}")
    if window is not None and window < 1:
        raise ValueError(f"prefill_attention: window {window} < 1")
    if cap is not None and not cap > 0:
        raise ValueError(f"prefill_attention: soft-cap {cap} must be > 0")
    if len({t.device for t in (lens, q, k, v)}) != 1:
        raise ValueError("prefill_attention: inputs lie on different devices")
    if q.device.type == "cpu":
        return prefill_attention_ref(lens, q, k, v, window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    if (q.dtype, k.dtype) not in _DTYPE_PAIRS or v.dtype != k.dtype:
        raise TypeError(f"prefill_attention: (q, k/v) must be fp32/fp32, "
                        f"fp32/bf16 or bf16/bf16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("prefill_attention: q, k, v must be contiguous")
    if hd > MAX_HEAD_DIM or b > 65535 or hkv > 65535:
        raise ValueError(f"prefill_attention: head dim {hd} > {MAX_HEAD_DIM} "
                         f"or grid too large (B={b}, Hkv={hkv})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lens = lens.to(torch.int32).contiguous()
    tc = route(q.dtype, k.dtype, hd) == "tensor_cores"
    if tc and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("prefill_attention: the tensor-core kernel needs "
                         "q, k, v 16-byte aligned")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tc:
            lib = LIB_TC
            status = _fn_tc()(lens.data_ptr(), q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), out.data_ptr(), b, c, h, hkv, hd,
                              s, window or 0, cap or 0.0, hd ** -0.5, stream)
        else:
            lib = LIB
            status = _fn()(lens.data_ptr(), q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), out.data_ptr(), b, c, h, hkv, hd, s,
                           window or 0, cap or 0.0, hd ** -0.5,
                           int(q.dtype == torch.bfloat16),
                           int(k.dtype == torch.bfloat16), stream)
    build.check_status(lib, status)
    build.count_launch(NAME if tc else NAME_CUDA_CORES)
    return out
