"""MZI-mesh parametrization of real orthogonal matrices (PyTorch port).

Counterpart of ``repro/core/unitary.py``.  Every unitary in ``W = U Σ V*``
is a mesh of 2×2 planar rotators:  ``U(k) = R_{T-1} ··· R_0 · D``  with
``T = k(k-1)/2`` adjacent-plane Givens rotations and a ±1 sign diagonal.

* The schedules (:class:`MeshSpec`, :func:`mesh_spec`) and the exact fp64
  decompositions are numpy, copied verbatim from the reference so they are
  identical to it.
* :func:`apply_mesh` / :func:`apply_mesh_transpose` are plain PyTorch:
  the mesh kernel's plain version (:func:`repro_torch.kernels.ref.
  mesh_apply_ref`, one Python loop step per mesh layer, where the
  reference ``lax.scan``s) on the spec's layer tables.
* :func:`build_unitary` is block-batched and goes through the mesh kernel
  (:mod:`repro_torch.kernels.mesh_apply`) on a CUDA tensor.

A rotation in plane ``(a, b)``, ``a < b``, with angle ``φ`` acts as::

    y_a = cos(φ) x_a − sin(φ) x_b
    y_b = sin(φ) x_a + cos(φ) x_b

``apply_mesh`` computes ``U @ x`` mixing ``x``'s LAST axis, ``D`` first.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.mesh_apply import layer_tables, mesh_apply_batched
from ..kernels.ref import mesh_apply_ref

__all__ = [
    "MeshSpec",
    "mesh_spec",
    "num_phases",
    "apply_mesh",
    "apply_mesh_transpose",
    "build_unitary",
    "decompose_reck",
    "decompose_clements",
    "decompose_batched",
    "decompose_reck_batched",
    "decompose_clements_batched",
    "decompose",
    "random_orthogonal",
    "np_build_unitary",
]


def num_phases(k: int) -> int:
    return k * (k - 1) // 2


# ---------------------------------------------------------------------------
# Mesh schedules (static numpy metadata) — verbatim from the reference
# ---------------------------------------------------------------------------


class MeshSpec(NamedTuple):
    """Static description of a k×k rotation mesh (numpy index tables)."""

    k: int
    kind: str
    n_rot: int
    n_layers: int
    # application-ordered rotation list
    pairs: np.ndarray        # (T, 2) int32, pairs[t] = (a, b), a < b
    # layered representation
    layer_slot: np.ndarray   # (L, k) int32 — phase index feeding wire w, -1 idle
    layer_partner: np.ndarray  # (L, k) int32 — partner wire (self if idle)
    layer_sign: np.ndarray   # (L, k) float32 — -1 upper wire, +1 lower, 0 idle
    # crosstalk adjacency: neighbours of each phase within its layer
    phase_neighbors: np.ndarray  # (T, 2) int32, -1 padded


def _reck_null_order(k: int) -> list[tuple[int, int]]:
    """Column-major bottom-up Givens nulling order (triangular mesh)."""
    order = []
    for c in range(k - 1):
        for r in range(k - 1, c, -1):
            order.append((r - 1, r))
    return order


def _clements_apply_order(k: int) -> tuple[list[tuple[int, int]], list[int]]:
    """Rectangular mesh: k alternating even/odd layers of adjacent pairs.

    Returns (pairs in application order, layer id per rotation).
    """
    pairs, layer_of = [], []
    for layer in range(k):
        start = layer % 2
        for a in range(start, k - 1, 2):
            pairs.append((a, a + 1))
            layer_of.append(layer)
    return pairs, layer_of


def _layerize(pairs: list[tuple[int, int]], k: int,
              layer_of: list[int] | None = None):
    """Greedy layering of an application-ordered rotation list.

    Rotations on disjoint wires commute, so consecutive disjoint rotations can
    share a layer; a rotation must come strictly after any earlier rotation
    touching one of its wires.
    """
    T = len(pairs)
    if layer_of is None:
        avail = np.zeros(k, dtype=np.int64)
        layer_of = []
        for (a, b) in pairs:
            l = int(max(avail[a], avail[b]))
            layer_of.append(l)
            avail[a] = avail[b] = l + 1
    n_layers = (max(layer_of) + 1) if T else 0

    layer_slot = np.full((max(n_layers, 1), k), -1, dtype=np.int32)
    layer_partner = np.tile(np.arange(k, dtype=np.int32), (max(n_layers, 1), 1))
    layer_sign = np.zeros((max(n_layers, 1), k), dtype=np.float32)
    # per-layer ordered list of phase slots for crosstalk adjacency
    per_layer_slots: list[list[tuple[int, int]]] = [[] for _ in range(max(n_layers, 1))]
    for t, (a, b) in enumerate(pairs):
        l = layer_of[t]
        layer_slot[l, a] = t
        layer_slot[l, b] = t
        layer_partner[l, a] = b
        layer_partner[l, b] = a
        layer_sign[l, a] = -1.0
        layer_sign[l, b] = 1.0
        per_layer_slots[l].append((a, t))

    neigh = np.full((max(T, 1), 2), -1, dtype=np.int32)
    for slots in per_layer_slots:
        slots.sort()  # by wire position within the layer
        for i, (_, t) in enumerate(slots):
            if i > 0:
                neigh[t, 0] = slots[i - 1][1]
            if i + 1 < len(slots):
                neigh[t, 1] = slots[i + 1][1]
    return n_layers, layer_slot, layer_partner, layer_sign, neigh


@functools.lru_cache(maxsize=None)
def mesh_spec(k: int, kind: str = "reck") -> MeshSpec:
    if k < 2:
        raise ValueError(f"mesh size must be >= 2, got {k}")
    if kind == "reck":
        null_order = _reck_null_order(k)
        pairs = list(reversed(null_order))  # application order
        layer_of = None
    elif kind == "clements":
        pairs, layer_of = _clements_apply_order(k)
    else:
        raise ValueError(f"unknown mesh kind: {kind!r}")
    n_layers, slot, partner, sign, neigh = _layerize(pairs, k, layer_of)
    return MeshSpec(
        k=k,
        kind=kind,
        n_rot=len(pairs),
        n_layers=n_layers,
        pairs=np.asarray(pairs, dtype=np.int32).reshape(-1, 2),
        layer_slot=slot,
        layer_partner=partner,
        layer_sign=sign,
        phase_neighbors=neigh,
    )


# ---------------------------------------------------------------------------
# PyTorch application
# ---------------------------------------------------------------------------


def _layer_tables(spec: MeshSpec, device, transpose: bool = False):
    """The spec's (slot, partner, sign) layer tables as tensors; for the
    transpose, the layers in reverse with negated signs."""
    slot, partner, sign = layer_tables(spec.k, spec.kind, device)
    if transpose:
        return slot.flip(0), partner.flip(0), -sign.flip(0)
    return slot, partner, sign


def apply_mesh(spec: MeshSpec, phases: torch.Tensor, x: torch.Tensor,
               d: torch.Tensor | None = None) -> torch.Tensor:
    """Compute ``U(phases, d) @ x`` mixing ``x``'s last axis.

    phases: (..., T)  — batch dims broadcast against x's
    x:      (..., k)
    d:      (..., k) ±1 sign diagonal or None (identity)
    """
    return mesh_apply_ref(x, phases, *_layer_tables(spec, x.device), d)


def apply_mesh_transpose(spec: MeshSpec, phases: torch.Tensor,
                         x: torch.Tensor,
                         d: torch.Tensor | None = None) -> torch.Tensor:
    """Compute ``U(phases, d)^T @ x`` (= U^{-1} x, U orthogonal).

    U^T = D · R_0^T ··· R_{T-1}^T — layers in reverse with negated angles.
    """
    x = mesh_apply_ref(x, phases, *_layer_tables(spec, x.device, True))
    if d is not None:
        x = x * d
    return x


@functools.lru_cache(maxsize=64)
def identity(k: int, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """The k × k identity on ``device``, made once and only read: every
    mesh build and every block probe streams it through."""
    return torch.eye(k, dtype=dtype, device=device)


def build_unitary(spec: MeshSpec, phases: torch.Tensor,
                  d: torch.Tensor | None = None) -> torch.Tensor:
    """Materialize ``U`` (..., k, k) from phases (..., T) and signs (..., k).

    Block-batched: all leading dims are flattened into one mesh batch and
    applied to the k unit vectors in a single mesh-kernel launch (the plain
    PyTorch version on a CPU tensor); the kernel writes each mesh's output
    transposed, so row ``j`` of the applied identity lands in column ``j``
    of ``U``.
    """
    k = spec.k
    bshape = phases.shape[:-1]
    if d is not None:
        bshape = torch.broadcast_shapes(bshape, d.shape[:-1])
        d = d.expand(bshape + (k,)).reshape(-1, k).contiguous()
    ph = phases.expand(bshape + (phases.shape[-1],)).reshape(
        -1, phases.shape[-1]).contiguous()
    eye = identity(k, phases.dtype, phases.device)[None]
    u = mesh_apply_batched(spec, ph, eye, d, transpose_out=True)
    return u.reshape(bshape + (k, k))


# ---------------------------------------------------------------------------
# Exact decomposition (numpy, float64) — verbatim from the reference
# ---------------------------------------------------------------------------


def decompose_reck(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact Reck-mesh decomposition of a real orthogonal ``Q``.

    Returns ``(phases, d)`` in *application order* such that
    ``U = R_{T-1} ··· R_0 · D == Q`` (matching :func:`apply_mesh`).

    Givens-null the subdiagonal column-major bottom-up; each left-applied
    nulling rotation ``G(θ)`` contributes ``R(θ) = G(θ)^T`` on the other side.
    """
    Q = np.asarray(Q, dtype=np.float64)
    k = Q.shape[0]
    if Q.shape != (k, k):
        raise ValueError(f"square matrix required, got {Q.shape}")
    A = Q.copy()
    thetas = []  # in nulling order
    for c in range(k - 1):
        for r in range(k - 1, c, -1):
            a, b = A[r - 1, c], A[r, c]
            th = np.arctan2(b, a)
            cth, sth = np.cos(th), np.sin(th)
            ra = cth * A[r - 1] + sth * A[r]
            rb = -sth * A[r - 1] + cth * A[r]
            A[r - 1], A[r] = ra, rb
            thetas.append(th)
    d = np.sign(np.diag(A))
    d[d == 0] = 1.0
    # application order = reversed nulling order
    phases = np.asarray(thetas[::-1], dtype=np.float64)
    return phases, d.astype(np.float64)


def decompose_clements(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact Clements-mesh decomposition of a real orthogonal ``Q``.

    Real-valued variant of Clements et al. (Optica 2016): anti-diagonals of
    the lower triangle are nulled alternately with rotations multiplied from
    the right (columns; odd anti-diagonals) and from the left (rows; even
    anti-diagonals):  ``L_s···L_1 · Q · R_1···R_t = D0``  giving

        Q = L_1^T···L_s^T · D0 · R_t^T···R_1^T
          = L_1^T···L_s^T · R_t^T'···R_1^T' · D0

    using the commutation rule ``D R(θ) = R(d_a d_b θ) D`` for a ±1 diagonal.
    The resulting rotation sequence tiles exactly the rectangular Clements
    mesh of :func:`mesh_spec`; phases are returned in its slot order.

    Returns ``(phases, d)`` such that ``apply_mesh(spec, phases, x, d)``
    reproduces ``Q @ x`` with ``spec = mesh_spec(k, "clements")``.
    """
    Q = np.asarray(Q, dtype=np.float64)
    k = Q.shape[0]
    if Q.shape != (k, k):
        raise ValueError(f"square matrix required, got {Q.shape}")
    A = Q.copy()
    rights: list[tuple[int, float]] = []  # (upper wire a, θ) in applied order
    lefts: list[tuple[int, float]] = []

    for i in range(1, k):
        if i % 2 == 1:
            # null A[k-1-j, i-1-j] from the RIGHT via columns (c, c+1)
            for j in range(i):
                r, c = k - 1 - j, i - 1 - j
                x, y = A[r, c], A[r, c + 1]
                th = np.arctan2(-x, y)
                cth, sth = np.cos(th), np.sin(th)
                ca = cth * A[:, c] + sth * A[:, c + 1]
                cb = -sth * A[:, c] + cth * A[:, c + 1]
                A[:, c], A[:, c + 1] = ca, cb
                rights.append((c, th))
        else:
            # null A[k-i+j-1, j-1] from the LEFT via rows (r-1, r)
            for j in range(1, i + 1):
                r, c = k - i + j - 1, j - 1
                x, y = A[r - 1, c], A[r, c]
                th = np.arctan2(y, x)
                cth, sth = np.cos(th), np.sin(th)
                ra = cth * A[r - 1] + sth * A[r]
                rb = -sth * A[r - 1] + cth * A[r]
                A[r - 1], A[r] = ra, rb
                lefts.append((r - 1, th))

    d = np.sign(np.diag(A))
    d[d == 0] = 1.0

    # Assemble application-ordered rotation list for U = (rots)·D0.
    # R_m applied on the right contributes R^T(θ_m) = R(-θ_m); commuting D0
    # rightwards multiplies the angle by d_a·d_b.  L_m contributes R(-θ_m)
    # already left of D0.
    app: list[tuple[int, float]] = []
    for a, th in rights:  # R_1^T' applied first, ... R_t^T'
        app.append((a, -th * d[a] * d[a + 1]))
    # L_m as implemented is R(-θ_m), so L_m^T = R(+θ_m)
    for a, th in reversed(lefts):  # then L_s^T ... L_1^T
        app.append((a, th))

    # Map the application-ordered rotations onto the canonical Clements slots.
    spec = mesh_spec(k, "clements")
    slot_of: dict[tuple[int, int], int] = {}
    t = 0
    pairs, layer_of = _clements_apply_order(k)
    for (a, _b), l in zip(pairs, layer_of):
        slot_of[(l, a)] = t
        t += 1
    phases = np.zeros(spec.n_rot, dtype=np.float64)
    filled = np.zeros(spec.n_rot, dtype=bool)
    wire_free = np.zeros(k, dtype=np.int64)  # earliest layer each wire is free
    for a, th in app:
        l = int(max(wire_free[a], wire_free[a + 1]))
        # advance to the canonical layer with matching parity
        while (l % 2) != (a % 2) or (l, a) not in slot_of or filled[slot_of[(l, a)]]:
            l += 1
            if l > 2 * k:
                raise AssertionError("clements layer assignment failed")
        s = slot_of[(l, a)]
        phases[s] = th
        filled[s] = True
        wire_free[a] = wire_free[a + 1] = l + 1
    if not filled.all():
        raise AssertionError("clements decomposition did not fill every slot")
    return phases, d.astype(np.float64)


def decompose(Q: np.ndarray, kind: str = "reck"):
    if kind == "reck":
        return decompose_reck(Q)
    if kind == "clements":
        return decompose_clements(Q)
    raise ValueError(f"unknown mesh kind: {kind!r}")


# ---------------------------------------------------------------------------
# Batched exact decomposition (float64): the same rotation sequence as the
# per-matrix functions above, walked once over all matrices at a time
# ---------------------------------------------------------------------------


def _as_batch(Q) -> torch.Tensor:
    """(b, k, k) matrices (numpy or a tensor) as a (k, k, b) float64 copy on
    their device: batch last, so each row and column a rotation touches is
    one contiguous (k, b) slab."""
    A = torch.as_tensor(Q)
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"(b, k, k) matrices required, got {tuple(A.shape)}")
    return A.to(torch.float64).permute(1, 2, 0).contiguous()


def _signs(A: torch.Tensor) -> torch.Tensor:
    d = torch.sign(torch.diagonal(A, dim1=0, dim2=1))         # (b, k)
    return torch.where(d == 0, torch.ones_like(d), d)


def _like(Q, *outs):
    """``outs`` as numpy when ``Q`` was numpy, else as tensors."""
    if isinstance(Q, torch.Tensor):
        return outs
    return tuple(o.cpu().numpy() for o in outs)


def _rotate_rows(A: torch.Tensor, r0: int, r1: int, c, s) -> None:
    ra = c * A[r0] + s * A[r1]
    rb = -s * A[r0] + c * A[r1]
    A[r0], A[r1] = ra, rb


def decompose_reck_batched(Q):
    """:func:`decompose_reck` of each of ``Q``'s (b, k, k) matrices: phases
    (b, T) and signs (b, k), computed in float64 on ``Q``'s device (numpy
    in, numpy out).  Each Givens step is the scalar path's arithmetic on b
    values at a time."""
    A = _as_batch(Q)
    k, _, b = A.shape
    thetas = []
    for c in range(k - 1):
        for r in range(k - 1, c, -1):
            th = torch.atan2(A[r, c], A[r - 1, c])
            _rotate_rows(A, r - 1, r, torch.cos(th), torch.sin(th))
            thetas.append(th)
    # application order = reversed nulling order
    phases = (torch.stack(thetas[::-1], dim=1) if thetas
              else A.new_zeros((b, 0)))
    return _like(Q, phases, _signs(A))


@functools.lru_cache(maxsize=None)
def _clements_slots(k: int) -> tuple[int, ...]:
    """The canonical slot of each rotation of :func:`decompose_clements`'s
    application order (right rotations in order, then the left ones
    reversed): the assignment depends on their wires alone."""
    rights = [i - 1 - j for i in range(1, k, 2) for j in range(i)]
    lefts = [k - i + j - 2 for i in range(2, k, 2) for j in range(1, i + 1)]
    slot_of: dict[tuple[int, int], int] = {}
    pairs, layer_of = _clements_apply_order(k)
    for t, ((a, _b), l) in enumerate(zip(pairs, layer_of)):
        slot_of[(l, a)] = t
    filled: set[int] = set()
    wire_free = [0] * k
    slots = []
    for a in rights + lefts[::-1]:
        l = max(wire_free[a], wire_free[a + 1])
        while (l % 2) != (a % 2) or (l, a) not in slot_of \
                or slot_of[(l, a)] in filled:
            l += 1
            if l > 2 * k:
                raise AssertionError("clements layer assignment failed")
        filled.add(slot_of[(l, a)])
        slots.append(slot_of[(l, a)])
        wire_free[a] = wire_free[a + 1] = l + 1
    if len(filled) != mesh_spec(k, "clements").n_rot:
        raise AssertionError("clements decomposition did not fill every slot")
    return tuple(slots)


def decompose_clements_batched(Q):
    """:func:`decompose_clements` of each of ``Q``'s (b, k, k) matrices:
    phases (b, T) in the canonical slot order and signs (b, k), in float64
    on ``Q``'s device (numpy in, numpy out)."""
    A = _as_batch(Q)
    k, _, b = A.shape
    rights, lefts = [], []
    for i in range(1, k):
        if i % 2 == 1:
            # null A[k-1-j, i-1-j] from the RIGHT via columns (c, c+1)
            for j in range(i):
                r, c = k - 1 - j, i - 1 - j
                th = torch.atan2(-A[r, c], A[r, c + 1])
                cth, sth = torch.cos(th), torch.sin(th)
                ca = cth * A[:, c] + sth * A[:, c + 1]
                cb = -sth * A[:, c] + cth * A[:, c + 1]
                A[:, c], A[:, c + 1] = ca, cb
                rights.append((c, th))
        else:
            # null A[k-i+j-1, j-1] from the LEFT via rows (r-1, r)
            for j in range(1, i + 1):
                r, c = k - i + j - 1, j - 1
                th = torch.atan2(A[r, c], A[r - 1, c])
                _rotate_rows(A, r - 1, r, torch.cos(th), torch.sin(th))
                lefts.append(th)
    d = _signs(A)
    # R_m^T' = R(-θ_m · d_a · d_{a+1}) commuted right of D0; L_m^T = R(θ_m)
    app = [-th * d[:, a] * d[:, a + 1] for a, th in rights] + lefts[::-1]
    phases = A.new_zeros((b, len(app)))
    if app:
        phases[:, list(_clements_slots(k))] = torch.stack(app, dim=1)
    return _like(Q, phases, d)


def decompose_batched(Q, kind: str = "reck"):
    """:func:`decompose` of each of ``Q``'s (b, k, k) matrices in one pass:
    ``(phases (b, T), d (b, k))`` in float64, on ``Q``'s device."""
    if kind == "reck":
        return decompose_reck_batched(Q)
    if kind == "clements":
        return decompose_clements_batched(Q)
    raise ValueError(f"unknown mesh kind: {kind!r}")


# ---------------------------------------------------------------------------
# Reference helpers — verbatim from the reference
# ---------------------------------------------------------------------------


def np_build_unitary(spec: MeshSpec, phases: np.ndarray,
                     d: np.ndarray | None = None) -> np.ndarray:
    """Pure-numpy float64 oracle for :func:`build_unitary`."""
    k = spec.k
    U = np.eye(k) if d is None else np.diag(np.asarray(d, dtype=np.float64))
    for t in range(spec.n_rot):
        a, b = spec.pairs[t]
        R = np.eye(k)
        c, s = np.cos(phases[t]), np.sin(phases[t])
        R[a, a] = c
        R[a, b] = -s
        R[b, a] = s
        R[b, b] = c
        U = R @ U
    return U


def random_orthogonal(key_or_seed, k: int) -> np.ndarray:
    """Haar-ish random real orthogonal matrix (numpy, float64)."""
    rng = np.random.default_rng(
        key_or_seed if isinstance(key_or_seed, (int, np.integer)) else None)
    M = rng.standard_normal((k, k))
    Qm, Rm = np.linalg.qr(M)
    return Qm * np.sign(np.diag(Rm))
