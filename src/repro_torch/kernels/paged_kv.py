"""Paged KV-cache page assembly (gather) and row insertion (scatter): wrappers.

Counterpart of ``repro/kernels/paged_kv.py`` (+ its dispatch in
``repro/kernels/ops.py``).  On a CUDA tensor each wrapper launches its
hand-written kernel in ``csrc/paged_kv.cu``; on a CPU tensor it runs the
plain PyTorch version (:mod:`.ref`).

* :func:`paged_gather` assembles each table row's pages into one
  contiguous view: an exact copy, bitwise equal to ``pages[table]``.
* :func:`paged_scatter` writes rows at (page, offset) targets **in place**
  and returns the same ``pages`` tensor (the reference aliases the pool
  into its output; here the pool is simply updated).  Duplicate targets
  resolve last-wins, as the reference's sequential grid does.
  :func:`paged_scatter_rows` is the same call under the chunked-prefill
  name.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import paged_gather_ref, paged_scatter_ref

__all__ = ["paged_gather", "paged_scatter", "paged_scatter_rows"]

LIB = "paged_kv"


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(build.library(LIB), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _vec_bytes(nbytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy unit (16..1 bytes) dividing ``nbytes`` and every
    base address."""
    for w in (16, 8, 4, 2, 1):
        if nbytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 1


def _check_pool(name: str, pages: torch.Tensor, *others: torch.Tensor):
    if pages.dim() != 3:
        raise ValueError(f"{name}: pages must be (n_pages, page_size, d), "
                         f"got {tuple(pages.shape)}")
    if len({t.device for t in (pages, *others)}) != 1:
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(t.is_contiguous() for t in (pages, *others)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if pages.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {pages.device}")


def paged_gather(table: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """table: (B, J) int32 page ids (unallocated entries hold a valid id,
    0 by convention); pages: (n_pages, page_size, d)  →  (B, J·page_size,
    d) in pages' dtype.  An id outside the pool (negative ones included)
    raises an IndexError in the plain version and stops the kernel with a
    device trap."""
    if table.dim() != 2 or table.dtype != torch.int32:
        raise ValueError(f"paged_gather: table must be (B, J) int32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    _check_pool("paged_gather", pages, table)
    if pages.device.type == "cpu":
        return paged_gather_ref(table, pages)
    b, j = table.shape
    n_pages, ps, d = pages.shape
    out = torch.empty((b, j * ps, d), dtype=pages.dtype, device=pages.device)
    if out.numel() == 0:
        return out
    if b * j >= 2 ** 31 or n_pages >= 2 ** 31:
        raise ValueError(f"paged_gather: table {b}x{j} too large")
    page_bytes = ps * d * pages.element_size()
    with torch.cuda.device(pages.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _fn("paged_gather", 3, 3)(
            table.data_ptr(), pages.data_ptr(), out.data_ptr(), b, j, n_pages,
            page_bytes, _vec_bytes(page_bytes, pages, out), stream)
    build.check_status(LIB, status)
    build.count_launch("paged_gather")
    return out


def paged_scatter(idx: torch.Tensor, rows: torch.Tensor,
                  pages: torch.Tensor) -> torch.Tensor:
    """idx: (R, 2) int32 ``(page_id, offset)`` per row; rows: (R, d) in
    pages' dtype; pages: (n_pages, page_size, d), written in place and
    returned.  Duplicate targets: the last row wins.  Targets must lie in
    the pool: the plain version raises a ValueError otherwise, and the
    kernel stops with a device trap (a CUDA error at the next
    synchronisation)."""
    if idx.dim() != 2 or idx.shape[1] != 2 or idx.dtype != torch.int32:
        raise ValueError(f"paged_scatter: idx must be (R, 2) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    _check_pool("paged_scatter", pages, idx, rows)
    n_pages, ps, d = pages.shape
    if rows.shape != (idx.shape[0], d) or rows.dtype != pages.dtype:
        raise ValueError(f"paged_scatter: rows must be ({idx.shape[0]}, {d}) "
                         f"{pages.dtype}, got {tuple(rows.shape)} "
                         f"{rows.dtype}")
    if pages.device.type == "cpu":
        return paged_scatter_ref(idx, rows, pages)
    r = idx.shape[0]
    if r == 0:
        return pages
    if r >= 2 ** 31 or n_pages * ps >= 2 ** 31:
        raise ValueError(f"paged_scatter: {r} rows into {n_pages}x{ps} "
                         f"targets is too large")
    winner = torch.empty((n_pages * ps,), dtype=torch.int32,
                         device=pages.device)
    row_bytes = d * pages.element_size()
    with torch.cuda.device(pages.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _fn("paged_scatter", 4, 3)(
            idx.data_ptr(), rows.data_ptr(), pages.data_ptr(),
            winner.data_ptr(), r, n_pages, ps, row_bytes,
            _vec_bytes(row_bytes, rows, pages), stream)
    build.check_status(LIB, status)
    build.count_launch("paged_scatter")
    return pages


def paged_scatter_rows(idx: torch.Tensor, rows: torch.Tensor,
                       pages: torch.Tensor) -> torch.Tensor:
    """Multi-token insertion (chunked prefill): R row writes in one call —
    the same kernel as :func:`paged_scatter`."""
    return paged_scatter(idx, rows, pages)
