"""The unrolled wide ``mesh_apply`` kernel (k = 64 and 128): its rule, its
compiled rotation order and its (cos, sin) table, on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against its plain version at 1e-5); here:

* The route rule: k 64 and 128 take ``"wide_unrolled"``; 33, 100 and 192
  keep the list-driven wide kernel; k <= 32 the narrow one.  The new
  counter lives in the mesh library.
* ``unrolled_table`` below, the host mirror of the kernel's table and
  order (reck: sweep i from slot i (i + 1) / 2, stored
  from a group of 8 wires with identity rotations below its first wire;
  clements: even and odd layers in alternation), applies every phase slot
  once, in the order of ``mesh_spec(k, kind).pairs``, on the pairs' upper
  wires; every other entry is an identity or a pad, and the reck sweeps
  start on 16-byte boundaries (the kernel reads them four floats at a
  time).
* An emulation of the kernel in that order (identities included, rows
  signed first) matches the plain version on the spec's layer tables and
  the reference package's ``build_unitary`` within 1e-5.
* ``mesh_apply_batched(force_route=...)`` refuses a route that cannot
  serve k, and on a CPU tensor every wide route runs the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unitary as jun
from repro_torch.core.unitary import mesh_spec
from repro_torch.kernels import build, mesh_apply_plain
from repro_torch.kernels.mesh_apply import (ROUTES, UNROLLED_K,
                                            mesh_apply_batched, route)

KINDS = ("clements", "reck")


def unrolled_table(k: int, kind: str) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """The unrolled kernel's (cos, sin) table and rotation order, laid out
    as ``csrc/mesh_apply.cu::mesh_apply_unrolled_kernel`` lays them out:
    ``slot`` (n,) int32, the phase slot of each table entry (-1 for an
    identity rotation or a pad), and, rotation by rotation in the order the
    kernel applies them, its table entry ``entry`` and upper wire
    ``upper``.  Reck: sweep i (c = k - 2 - i, slots from i (i + 1) / 2)
    stored from wire 8 (c // 8) to k - 1, its wires below c identities and
    wire k - 1 a pad, applied over its groups of 8 wires from c // 8 on.
    Clements: layer pair m as k entries (the even layer's k / 2, the odd
    layer's k / 2 - 1, a pad), entry w at slot m (k - 1) + w."""
    slot, entry, upper = [], [], []
    if kind == "reck":
        for i in range(k - 1):
            c = k - 2 - i
            lo = 8 * (c // 8)
            pos = len(slot)
            slot += [i * (i + 1) // 2 + a - c if c <= a < k - 1 else -1
                     for a in range(lo, k)]
            for a in range(lo, k - 1):
                entry.append(pos + a - lo)
                upper.append(a)
    else:
        for m in range(k // 2):
            slot += [m * (k - 1) + w if w < k - 1 else -1 for w in range(k)]
            entry += [m * k + w for w in range(k // 2)]
            upper += [2 * w for w in range(k // 2)]
            entry += [m * k + k // 2 + w for w in range(k // 2 - 1)]
            upper += [2 * w + 1 for w in range(k // 2 - 1)]
    return (np.asarray(slot, np.int32), np.asarray(entry, np.int32),
            np.asarray(upper, np.int32))


@pytest.mark.parametrize("k", UNROLLED_K)
def test_k_64_and_128_take_the_unrolled_route(k):
    assert route(k) == "wide_unrolled"


@pytest.mark.parametrize("k", [33, 100, 192])
def test_other_wide_k_keep_the_wide_kernel(k):
    assert route(k) == "wide"


@pytest.mark.parametrize("k", [2, 9, 32])
def test_k_up_to_32_stays_narrow(k):
    assert route(k) == "narrow"


def test_unrolled_counter_lives_in_the_mesh_library():
    assert ROUTES == {"narrow": "mesh_apply",
                      "wide_unrolled": "mesh_apply_wide_unrolled",
                      "wide": "mesh_apply_wide"}
    assert build.KERNELS["mesh_apply_wide_unrolled"] == "mesh_apply"
    assert "mesh_apply_wide_unrolled" in build.launch_counts


@pytest.mark.parametrize("k", UNROLLED_K)
@pytest.mark.parametrize("kind", KINDS)
def test_unrolled_order_is_the_mesh_order(k, kind):
    spec = mesh_spec(k, kind)
    slot, entry, upper = unrolled_table(k, kind)
    assert entry.shape == upper.shape
    assert 0 <= entry.min() and entry.max() < len(slot)
    live = slot[entry] >= 0
    # every phase slot once, in application order, on its pair's wires
    assert np.array_equal(slot[entry][live], np.arange(spec.n_rot))
    assert np.array_equal(upper[live], spec.pairs[:, 0])
    assert np.array_equal(spec.pairs[:, 1], spec.pairs[:, 0] + 1)
    # no entry is applied twice, every phase lies in the table once
    assert len(np.unique(entry)) == len(entry)
    assert np.array_equal(np.sort(slot[slot >= 0]), np.arange(spec.n_rot))
    assert 0 <= upper.min() and upper.max() <= k - 2
    if kind == "reck":
        # each sweep (a run of rising wires) starts on a group of 8 wires,
        # at an even entry (16-byte aligned), its identities below the
        # sweep's first phase: at most 7 identities a sweep (5% of the
        # rotations at k = 128, 11% at k = 64)
        starts = np.flatnonzero(np.diff(upper, prepend=k) <= 0)
        assert len(starts) == k - 1
        assert all(upper[i] % 8 == 0 and entry[i] % 2 == 0 for i in starts)
        assert len(entry) - spec.n_rot == sum(c % 8 for c in range(k - 1))
        assert len(entry) - spec.n_rot <= 7 * (k - 1)
    else:
        assert len(slot) == k * k // 2 and len(entry) == spec.n_rot


def _emulate(k, kind, ph, x, d):
    """The unrolled kernel's arithmetic: rows signed, then every rotation
    in the mirrored order with its table entry's (cos, sin), identities
    (cos 1, sin 0) included."""
    slot, entry, upper = unrolled_table(k, kind)
    c = torch.where(torch.from_numpy(slot >= 0),
                    torch.cos(ph[..., np.maximum(slot, 0)]), 1.0)
    s = torch.where(torch.from_numpy(slot >= 0),
                    torch.sin(ph[..., np.maximum(slot, 0)]), 0.0)
    v = (x * d[:, None, :]).clone()
    for e, a in zip(entry.tolist(), upper.tolist()):
        x0, x1 = v[..., a].clone(), v[..., a + 1].clone()
        ce, se = c[:, e, None], s[:, e, None]
        v[..., a] = ce * x0 - se * x1
        v[..., a + 1] = se * x0 + ce * x1
    return v


@pytest.mark.parametrize("k", UNROLLED_K)
@pytest.mark.parametrize("kind", KINDS)
def test_emulation_matches_plain_version_and_reference(k, kind):
    spec = mesh_spec(k, kind)
    rng = np.random.default_rng(k + (kind == "reck"))
    b = 2
    ph = torch.from_numpy(rng.uniform(-np.pi, np.pi, (b, spec.n_rot))
                          .astype(np.float32))
    d = torch.from_numpy(np.where(rng.random((b, k)) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    eye = torch.eye(k)[None].expand(b, -1, -1)
    got = _emulate(k, kind, ph, eye, d).transpose(1, 2)      # U, as built
    want = mesh_apply_plain(spec, ph, torch.eye(k)[None], d,
                            transpose_out=True)
    assert float((got - want).abs().max()) < 1e-5
    jspec = jun.mesh_spec(k, kind)
    for i in range(b):
        uj = np.asarray(jun.build_unitary(
            jspec, jnp.asarray(ph[i].numpy(), jnp.float32),
            jnp.asarray(d[i].numpy(), jnp.float32)), np.float32)
        assert np.abs(got[i].numpy() - uj).max() < 1e-5
    # rows of their own
    x = torch.from_numpy(rng.standard_normal((b, 3, k)).astype(np.float32))
    assert float((_emulate(k, kind, ph, x, d)
                  - mesh_apply_plain(spec, ph, x, d)).abs().max()) < 1e-5


@pytest.mark.parametrize("k,forced", [(100, "wide_unrolled"),
                                      (33, "wide_unrolled"),
                                      (64, "narrow"), (32, "wide"),
                                      (128, "layered")])
def test_forced_routes_are_refused_where_they_cannot_serve(k, forced):
    spec = mesh_spec(k, "reck")
    ph = torch.zeros((2, spec.n_rot))
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match="no route"):
        mesh_apply_batched(spec, ph, torch.eye(k)[None], force_route=forced)
    assert build.launch_counts == before


@pytest.mark.parametrize("k", UNROLLED_K)
def test_cpu_tensors_run_the_plain_version_on_every_wide_route(k):
    spec = mesh_spec(k, "clements")
    rng = np.random.default_rng(k)
    ph = torch.from_numpy(rng.uniform(-3, 3, (2, spec.n_rot))
                          .astype(np.float32))
    eye = torch.eye(k)[None]
    before = dict(build.launch_counts)
    want = mesh_apply_plain(spec, ph, eye, transpose_out=True)
    for forced in (None, "wide_unrolled", "wide"):
        assert torch.equal(mesh_apply_batched(spec, ph, eye,
                                              transpose_out=True,
                                              force_route=forced), want)
    assert build.launch_counts == before
