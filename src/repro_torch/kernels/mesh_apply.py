"""Block-batched MZI mesh application ``y_b = U(Φ_b, D_b) x_b``: the wrapper.

Counterpart of ``repro/kernels/mesh_apply.py`` and the table pass of
``repro/kernels/ops.py::mesh_apply``.  On a CUDA tensor it launches one of
the three hand-written kernels in ``csrc/mesh_apply.cu`` (each computes
cos/sin itself), picked by :func:`route` from k alone and each counting
its launches under its own name: ``mesh_apply`` (k <= 32, a thread's
rows' wires in its registers, the rotation sequence unrolled at compile
time for the compiled widths 4, 8, 9, 16, 32 and each kind:
:func:`narrow_plan` maps any other k onto the next of them),
``mesh_apply_wide_unrolled`` (k = 64 and 128, :data:`UNROLLED_K`: a
thread's row's k wires in its registers, a CTA's mesh's (cos, sin) in
shared memory, the reck sweeps and clements layers unrolled at compile
time) and ``mesh_apply_wide``
(every other k > 32, a CTA's rows in shared memory, the rotations as a
list in layer order).  On a CPU tensor it runs the plain PyTorch version
(:func:`repro_torch.kernels.ref.mesh_apply_ref`).

``spec`` is a :class:`repro_torch.core.unitary.MeshSpec`; only its numpy
layer tables are read here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .ptc_block_matmul import MAX_K, kernel_k
from .ref import mesh_apply_ref

__all__ = ["mesh_apply", "mesh_apply_batched", "mesh_apply_plain",
           "layer_tables", "rotation_tables", "route", "narrow_plan",
           "NarrowPlan", "mesh_lib", "MAX_K", "UNROLLED_K", "ROUTES"]

NAME = "mesh_apply"                  # launch counter, k <= MAX_K
NAME_WIDE = "mesh_apply_wide"        # launch counter, other k > MAX_K
NAME_UNROLLED = "mesh_apply_wide_unrolled"   # launch counter, UNROLLED_K
ROUTES = {"narrow": NAME, "wide_unrolled": NAME_UNROLLED, "wide": NAME_WIDE}
UNROLLED_K = (64, 128)               # the unrolled kernel's compiled widths
_KINDS = {"clements": 0, "reck": 1}  # the kernels' kind argument


def route(k: int) -> str:
    """``"narrow"`` (a row's wires in registers) for k <= :data:`MAX_K`,
    ``"wide_unrolled"`` (a row's wires in registers, the order compiled)
    for k in :data:`UNROLLED_K`, ``"wide"`` for every other larger k.
    Reads nothing but its argument."""
    if k <= MAX_K:
        return "narrow"
    return "wide_unrolled" if k in UNROLLED_K else "wide"


def mesh_lib():
    """The loaded ``mesh_apply`` library (both routes)."""
    lib = build.library(NAME)
    fn = lib.mesh_apply_f32
    if fn.argtypes is None:
        head = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong]
        fn.argtypes = head + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        wide = lib.mesh_apply_wide_f32
        wide.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
            + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        wide.restype = ctypes.c_int
        unrolled = lib.mesh_apply_unrolled_f32
        unrolled.argtypes = head[:4] + [ctypes.c_void_p] \
            + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        unrolled.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def layer_tables(k: int, kind: str, device: torch.device):
    """The spec's layer tables on ``device``: (slot, partner, sign) for the
    plain version."""
    from ..core.unitary import mesh_spec
    spec = mesh_spec(k, kind)
    as_t = functools.partial(torch.as_tensor, device=device)
    return (as_t(spec.layer_slot.astype(np.int64)),
            as_t(spec.layer_partner.astype(np.int64)),
            as_t(spec.layer_sign))


@functools.lru_cache(maxsize=64)
def rotation_tables(k: int, kind: str, device: torch.device):
    """The wide kernel's rotation list in layer order: each rotation's
    upper wire and phase slot (int32), and each layer's first index into
    them (L + 1 entries)."""
    from ..core.unitary import mesh_spec
    spec = mesh_spec(k, kind)
    upper = spec.layer_sign < 0                          # (L, k)
    wire = np.nonzero(upper)[1].astype(np.int32)         # row-major: by layer
    slot = spec.layer_slot[upper].astype(np.int32)
    start = np.concatenate([[0], np.cumsum(upper.sum(1))]).astype(np.int32)
    as_t = functools.partial(torch.as_tensor, device=device)
    return as_t(wire), as_t(slot), as_t(start)


class NarrowPlan(NamedTuple):
    """The narrow kernel's launch for a (k, kind) mesh: the compiled width
    ``kk`` whose pattern it runs, the first of kk's wires that the k mesh
    takes, and each pattern rotation's phase slot in the k mesh (-1 where
    it has none; None where k is kk itself, the slot then the rotation's
    own index)."""
    kk: int
    off: int
    slot: np.ndarray | None


@functools.lru_cache(maxsize=None)
def narrow_plan(k: int, kind: str) -> NarrowPlan:
    """The k mesh as a part of the compiled kk mesh (kk the least of 4, 8,
    9, 16, 32 that holds k): a clements mesh on wires 0 .. k - 1 (layers
    0 .. k - 1 of kk's, their pairs below k), a reck mesh on wires
    kk - k .. kk - 1 (kk's last k - 1 nulling columns).  Each of the k
    mesh's rotations, in its application order, is matched to the next
    pattern rotation on the same wires; rotations on disjoint wires
    commute, so the kernel's order gives the layered order's bits.  The
    kernel's compiled pattern (``csrc/mesh_apply.cu::pattern_upper``) is
    the kk mesh's own application order, ``mesh_spec(kk, kind).pairs``."""
    from ..core.unitary import mesh_spec
    if not 2 <= k <= MAX_K:
        raise ValueError(f"mesh_apply: k = {k} outside 2..{MAX_K}")
    kk = kernel_k(k)
    upper = mesh_spec(kk, kind).pairs[:, 0]
    if kk == k:
        return NarrowPlan(kk, 0, None)
    off = kk - k if kind == "reck" else 0
    pairs = mesh_spec(k, kind).pairs
    slot = np.full(upper.shape, -1, dtype=np.int32)
    j = 0
    for t, a in enumerate(upper):
        if j < len(pairs) and pairs[j][0] == a - off:
            slot[t] = j
            j += 1
    if j != len(pairs):
        raise AssertionError(f"mesh_apply: the {kind} mesh of k = {k} is "
                             f"not a part of the k = {kk} pattern")
    return NarrowPlan(kk, off, slot)


@functools.lru_cache(maxsize=64)
def _narrow_slots(k: int, kind: str, device: torch.device):
    slot = narrow_plan(k, kind).slot
    return None if slot is None else torch.as_tensor(slot, device=device)


def mesh_apply_plain(spec, phases: torch.Tensor, x: torch.Tensor,
                     d: torch.Tensor | None = None, *,
                     transpose_out: bool = False) -> torch.Tensor:
    """The plain PyTorch version of :func:`mesh_apply_batched`, on any
    device (the wrapper's path for CPU tensors; the kernel's reference on
    the card)."""
    slot, partner, sign = layer_tables(spec.k, spec.kind, x.device)
    y = mesh_apply_ref(x.expand(phases.shape[0], -1, -1), phases[:, None],
                       slot, partner, sign, None if d is None else d[:, None])
    return y.transpose(1, 2).contiguous() if transpose_out else y.contiguous()


def mesh_apply_batched(spec, phases: torch.Tensor, x: torch.Tensor,
                       d: torch.Tensor | None = None, *,
                       transpose_out: bool = False,
                       force_route: str | None = None) -> torch.Tensor:
    """Apply mesh ``b`` to the rows of ``x[b]`` for every mesh of a batch.

    phases: (B, T) fp32 contiguous; x: (B or 1, R, k) fp32 whose rows are
    contiguous (a leading 1 shares x across all meshes); d: (B, k) ±1 signs
    or None.  Returns (B, R, k), or (B, k, R) with ``transpose_out`` (for
    ``build_unitary``: row j of the applied identity is column j of U).
    ``force_route`` overrides :func:`route` (for measuring the wide
    kernels in turns; the callers in the port pass none).
    """
    k, t = spec.k, spec.n_rot
    if phases.dim() != 2 or phases.shape[1] != t:
        raise ValueError(f"mesh_apply: phases {tuple(phases.shape)} is not "
                         f"(B, {t})")
    b = phases.shape[0]
    if x.dim() != 3 or x.shape[2] != k or x.shape[0] not in (1, b):
        raise ValueError(f"mesh_apply: x {tuple(x.shape)} is not "
                         f"({b} or 1, R, {k})")
    if d is not None and tuple(d.shape) != (b, k):
        raise ValueError(f"mesh_apply: d {tuple(d.shape)} is not ({b}, {k})")
    ins = (phases, x) if d is None else (phases, x, d)
    if any(a.dtype != torch.float32 for a in ins):
        raise TypeError("mesh_apply: phases, x and d must be float32")
    if len({a.device for a in ins}) != 1:
        raise ValueError("mesh_apply: inputs lie on different devices")
    if not phases.is_contiguous() or (d is not None and not d.is_contiguous()) \
            or x.stride(2) != 1 or (x.shape[1] > 1 and x.stride(1) != k):
        raise ValueError("mesh_apply: phases, d and the rows of x must be "
                         "contiguous")
    which = force_route or route(k)
    serves = {"narrow": k <= MAX_K, "wide_unrolled": k in UNROLLED_K,
              "wide": k > MAX_K}
    if not serves.get(which, False):
        raise ValueError(f"mesh_apply: no route {which!r} for k = {k}")
    r = x.shape[1]
    if x.device.type == "cpu":
        return mesh_apply_plain(spec, phases, x, d,
                                transpose_out=transpose_out)
    if x.device.type != "cuda":
        raise ValueError(f"mesh_apply: unsupported device {x.device}")
    out = torch.empty((b, k, r) if transpose_out else (b, r, k),
                      dtype=x.dtype, device=x.device)
    if b == 0 or r == 0:
        return out
    x_bstride = x.stride(0) if x.shape[0] == b and b > 1 else 0
    y_rstride, y_wstride = (1, r) if transpose_out else (k, 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        lib = mesh_lib()
        dptr = 0 if d is None else d.data_ptr()
        if which == "wide_unrolled":
            status = lib.mesh_apply_unrolled_f32(
                x.data_ptr(), x_bstride, phases.data_ptr(), dptr,
                out.data_ptr(), r * k, y_rstride, y_wstride, b, r, k, t,
                _KINDS[spec.kind], stream)
        elif which == "wide":
            wire, slot, start = rotation_tables(k, spec.kind, x.device)
            status = lib.mesh_apply_wide_f32(
                x.data_ptr(), x_bstride, phases.data_ptr(), dptr,
                wire.data_ptr(), slot.data_ptr(), start.data_ptr(),
                out.data_ptr(), r * k, y_rstride, y_wstride, b, r, k, t,
                start.shape[0] - 1, stream)
        else:
            slot = _narrow_slots(k, spec.kind, x.device)
            status = lib.mesh_apply_f32(
                x.data_ptr(), x_bstride, phases.data_ptr(), dptr,
                0 if slot is None else slot.data_ptr(), out.data_ptr(),
                r * k, y_rstride, y_wstride, b, r, k, t, _KINDS[spec.kind],
                narrow_plan(k, spec.kind).off, stream)
    build.check_status(NAME, status)
    build.count_launch(ROUTES[which])
    return out


def mesh_apply(spec, phases: torch.Tensor, x: torch.Tensor,
               d: torch.Tensor | None = None) -> torch.Tensor:
    """U(Φ, D) @ x for one mesh — the reference ``ops.mesh_apply`` signature.

    phases: (T,); x: (B, k); d: (k,) | None  →  (B, k).
    """
    return mesh_apply_batched(spec, phases[None], x[None],
                              None if d is None else d[None])[0]
