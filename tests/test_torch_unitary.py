"""Port parity: ``repro_torch.core.unitary`` against ``repro.core.unitary``.

The schedules and the fp64 decompositions are numpy copies and must be
identical.  The batched decomposition (``decompose_batched``: the same
rotation sequence over all blocks at once, vector transcendental functions
that may differ from the scalar path by an ulp) holds every block's phases
within 1e-12 of the reference's per-matrix ``decompose`` and its signs
exactly, on numpy and on tensors.  The PyTorch mesh application is held to 1e-5 absolute: both
sides compute in float32 (cast explicitly; the suite runs JAX with x64 on)
and differ only in the order of a few multiply-adds per layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unitary as jun
from repro_torch.core import unitary as tun

KS = [2, 4, 8, 9, 13, 16]
KINDS = ["clements", "reck"]
ATOL = 1e-5


@pytest.mark.parametrize("k", KS + [3])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_schedules_identical(k, kind):
    a, b = jun.mesh_spec(k, kind), tun.mesh_spec(k, kind)
    assert (a.k, a.kind, a.n_rot, a.n_layers) == \
        (b.k, b.kind, b.n_rot, b.n_layers)
    for field in ("pairs", "layer_slot", "layer_partner", "layer_sign",
                  "phase_neighbors"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_decompositions_identical(k, kind):
    q = jun.random_orthogonal(100 + k, k)
    assert np.array_equal(q, tun.random_orthogonal(100 + k, k))
    ph_j, d_j = jun.decompose(q, kind)
    ph_t, d_t = tun.decompose(q, kind)
    assert np.array_equal(ph_j, ph_t) and np.array_equal(d_j, d_t)
    spec = jun.mesh_spec(k, kind)
    np.testing.assert_array_equal(jun.np_build_unitary(spec, ph_j, d_j),
                                  tun.np_build_unitary(tun.mesh_spec(k, kind),
                                                       ph_t, d_t))


@pytest.mark.parametrize("k", [2, 3, 4, 8, 9, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_batched_decomposition_matches_reference_per_block(k, kind):
    rng = np.random.default_rng(300 + k)
    qs = np.stack([jun.random_orthogonal(int(s), k)
                   for s in rng.integers(0, 2 ** 31, 40)])
    # sign-flipped columns and the identity: diagonal signs of both kinds
    qs[1] = np.eye(k)
    qs[2] = qs[3] * np.where(np.arange(k) % 2, -1.0, 1.0)
    ph, d = tun.decompose_batched(qs, kind)
    ph_t, d_t = tun.decompose_batched(torch.from_numpy(qs), kind)
    assert isinstance(ph, np.ndarray) and ph.shape == (40, k * (k - 1) // 2)
    assert torch.equal(ph_t, torch.from_numpy(ph))
    assert torch.equal(d_t, torch.from_numpy(d))
    for i, q in enumerate(qs):
        ph_j, d_j = jun.decompose(q, kind)
        assert np.abs(ph[i] - ph_j).max() <= 1e-12
        assert np.array_equal(d[i], d_j)


def _mesh_inputs(k, kind, batch=()):
    rng = np.random.default_rng(k + (0 if kind == "clements" else 50))
    t = jun.mesh_spec(k, kind).n_rot
    ph = rng.uniform(-np.pi, np.pi, batch + (t,)).astype(np.float32)
    d = rng.choice([-1.0, 1.0], batch + (k,)).astype(np.float32)
    return ph, d


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_apply_mesh_and_transpose_match(k, kind):
    ph, d = _mesh_inputs(k, kind)
    x = np.random.default_rng(7).standard_normal((24, k)).astype(np.float32)
    jspec, tspec = jun.mesh_spec(k, kind), tun.mesh_spec(k, kind)
    for jf, tf in ((jun.apply_mesh, tun.apply_mesh),
                   (jun.apply_mesh_transpose, tun.apply_mesh_transpose)):
        yj = jf(jspec, jnp.asarray(ph), jnp.asarray(x), jnp.asarray(d))
        yt = tf(tspec, torch.from_numpy(ph), torch.from_numpy(x),
                torch.from_numpy(d))
        assert yt.dtype == torch.float32
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj, np.float32),
                                   atol=ATOL)
    # U^T U x = x, without signs
    xt = torch.from_numpy(x)
    back = tun.apply_mesh_transpose(tspec, torch.from_numpy(ph),
                                    tun.apply_mesh(tspec, torch.from_numpy(ph),
                                                   xt))
    np.testing.assert_allclose(back.numpy(), x, atol=ATOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_build_unitary_batched_matches(k, kind):
    ph, d = _mesh_inputs(k, kind, batch=(5, 3))
    uj = jun.build_unitary(jun.mesh_spec(k, kind), jnp.asarray(ph),
                           jnp.asarray(d))
    ut = tun.build_unitary(tun.mesh_spec(k, kind), torch.from_numpy(ph),
                           torch.from_numpy(d))
    assert ut.shape == (5, 3, k, k) and ut.is_contiguous()
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj, np.float32),
                               atol=ATOL)
    # without signs, and against the fp64 oracle
    ut0 = tun.build_unitary(tun.mesh_spec(k, kind), torch.from_numpy(ph[0]))
    for i in range(3):
        np.testing.assert_allclose(
            ut0[i].numpy(),
            tun.np_build_unitary(tun.mesh_spec(k, kind), ph[0, i]),
            atol=ATOL)
