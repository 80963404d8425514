"""Port parity: ``repro_torch.core.noise`` and ``core.ptc`` against the
reference, on the same float32 numpy inputs.

Quantization must agree exactly, exact-half ties included (both round half
to even on the same IEEE division).  Elementwise noise is held to 1e-5
absolute (phases up to ~10 rad in fp32).  The SVD is compared by composed
blocks and singular values (1e-5): the two libraries may flip the signs of
singular-vector pairs.  Forward paths: 1e-4 relative, as the kernel suite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise, ptc as jptc, unitary as jun
from repro_torch import convert
from repro_torch.core import noise as tnoise, ptc as tptc, unitary as tun
from repro_torch.hw.device import sample_device


def test_quantize_phase_including_exact_half_ties():
    step = 2 * np.pi / 255
    ties = ((np.arange(0, 255) + 0.5) * step).astype(np.float32)
    wide = np.random.default_rng(0).uniform(-20, 20, 4000).astype(np.float32)
    for ph in (ties, wide):
        for bits in (8, 4, None):
            qj = np.asarray(jnoise.quantize_phase(jnp.asarray(ph), bits))
            qt = tnoise.quantize_phase(torch.from_numpy(ph), bits).numpy()
            np.testing.assert_array_equal(qt, qj)
    # both round half to even where a quotient lands on .5 exactly
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    assert torch.round(halves).tolist() == \
        np.asarray(jnp.round(jnp.asarray(halves.numpy()))).tolist() == \
        [0.0, 2.0, 2.0, -0.0, -2.0]


@pytest.mark.parametrize("kind", ["clements", "reck"])
@pytest.mark.parametrize("omega", [0.0, 0.005, 0.2])
def test_crosstalk_couple_matches(kind, omega):
    spec_j, spec_t = jun.mesh_spec(9, kind), tun.mesh_spec(9, kind)
    ph = np.random.default_rng(1).uniform(
        -np.pi, np.pi, (4, 3, spec_j.n_rot)).astype(np.float32)
    yj = jnoise.crosstalk_couple(spec_j, jnp.asarray(ph), omega)
    yt = tnoise.crosstalk_couple(spec_t, torch.from_numpy(ph), omega)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj, np.float32),
                               atol=1e-6)


@pytest.mark.parametrize("frame", ["default", "post_ic", "off"])
def test_apply_phase_noise_matches(frame):
    model_j = {"default": jnoise.DEFAULT_NOISE,
               "post_ic": jnoise.DEFAULT_NOISE.post_ic(),
               "off": jnoise.DEFAULT_NOISE.off()}[frame]
    model_t = convert.noise_model(model_j)
    assert dataclasses.asdict(model_t) == dataclasses.asdict(model_j)
    rng = np.random.default_rng(2)
    spec_j, spec_t = jun.mesh_spec(9, "clements"), tun.mesh_spec(9, "clements")
    shape = (6, spec_j.n_rot)
    ph = rng.uniform(-np.pi, np.pi, shape).astype(np.float32)
    gamma = (1 + 0.002 * rng.standard_normal(shape)).astype(np.float32)
    bias = rng.uniform(0, 2 * np.pi, shape).astype(np.float32)
    nz_j = jnoise.PhaseNoise(jnp.asarray(gamma), jnp.asarray(bias))
    yj = jnoise.apply_phase_noise(spec_j, jnp.asarray(ph), nz_j, model_j)
    yt = tnoise.apply_phase_noise(spec_t, torch.from_numpy(ph),
                                  convert.phase_noise(nz_j), model_t)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj, np.float32),
                               atol=1e-5)


def test_sample_device_draws_the_reference_distribution():
    """Realizations come from a torch.Generator, so only the distribution
    is compared: shapes, ±1 signs, Γ ~ N(1, σ²), Φ_b ~ U(0, 2π)."""
    model = tnoise.NoiseModel()
    dev = sample_device(torch.Generator().manual_seed(0), (4000,), 9, model)
    t = tun.mesh_spec(9, "clements").n_rot
    assert dev.noise_u.gamma.shape == (4000, t) and dev.d_v.shape == (4000, 9)
    assert set(torch.unique(dev.d_u).tolist()) == {-1.0, 1.0}
    g = dev.noise_u.gamma
    assert abs(float(g.mean()) - 1) < 1e-4
    assert abs(float(g.std()) - model.gamma_std) < 1e-4
    b = dev.noise_v.bias
    assert float(b.min()) >= 0 and float(b.max()) < 2 * np.pi
    assert abs(float(b.mean()) - np.pi) < 0.02
    post = sample_device(torch.Generator().manual_seed(0), (3,), 9,
                         model.post_ic())
    assert float(post.noise_u.bias.abs().max()) == 0.0


def test_blockize_unblockize_identical():
    w = np.random.default_rng(3).standard_normal((20, 31)).astype(np.float32)
    bj = np.asarray(jptc.blockize(jnp.asarray(w), 9))
    bt = tptc.blockize(torch.from_numpy(w), 9)
    assert bt.shape == bj.shape == (3, 4, 9, 9)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(tptc.unblockize(bt, 20, 31).numpy(), w)
    np.testing.assert_array_equal(tptc.unblockize(bt).numpy(),
                                  np.asarray(jptc.unblockize(jnp.asarray(bj))))


def test_svd_factorize_compared_by_composed_weight():
    w = (np.random.default_rng(4).standard_normal((18, 27)) * 0.3).astype(
        np.float32)
    pj = jptc.svd_factorize(jnp.asarray(w), 9)
    pt = tptc.svd_factorize(torch.from_numpy(w), 9)
    np.testing.assert_allclose(pt.s.numpy(), np.asarray(pj.s, np.float32),
                               atol=1e-5)
    wj = np.asarray(jptc.compose_weight(pj), np.float32)
    wt = tptc.compose_weight(pt).numpy()
    np.testing.assert_allclose(wt, wj, atol=1e-5)
    np.testing.assert_allclose(tptc.unblockize(tptc.compose_weight(pt), 18,
                                               27).numpy(), w, atol=1e-5)


@pytest.mark.parametrize("m,n,rows", [(18, 27, 16), (20, 31, 7)])
def test_ptc_forwards_match(m, n, rows):
    rng = np.random.default_rng(m + n)
    w = (rng.standard_normal((m, n)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, rows, n)).astype(np.float32)
    pj = jptc.svd_factorize(jnp.asarray(w), 9)
    pt = convert.ptc_params(pj)
    for fj, ft in ((jptc.ptc_forward_blocked, tptc.ptc_forward_blocked),
                   (jptc.ptc_forward_fused, tptc.ptc_forward_fused)):
        yj = np.asarray(fj(pj, jnp.asarray(x), m), np.float32)
        yt = ft(pt, torch.from_numpy(x), m).numpy()
        assert yt.shape == (2, rows, m)
        assert np.abs(yt - yj).max() / np.abs(yj).max() < 1e-4


def test_block_energy_and_identity_factorize_match():
    s = np.random.default_rng(2).standard_normal((3, 4, 9)).astype(np.float32)
    u = np.zeros((3, 4, 9, 9), np.float32)
    ej = np.asarray(jptc.block_energy(jptc.PTCParams(
        jnp.asarray(u), jnp.asarray(s), jnp.asarray(u))))
    et = tptc.block_energy(tptc.PTCParams(*(torch.from_numpy(a)
                                            for a in (u, s, u))))
    assert et.shape == (3, 4) and et.dtype == torch.float32
    np.testing.assert_allclose(et.numpy(), ej, rtol=1e-6)
    fj = jptc.identity_factorize(20, 31, 9)
    ft = tptc.identity_factorize(20, 31, 9)
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_random_factorize_follows_the_reference_init():
    """Haar bases and Glorot-matched Σ on the reference's (P, Q) grid (the
    two packages draw different numbers, so the law is compared)."""
    m, n, k = 60, 100, 9
    fj = jptc.random_factorize(jax.random.PRNGKey(0), m, n, k)
    ft = tptc.random_factorize(torch.Generator().manual_seed(0), m, n, k)
    for a, b in zip(ft, fj):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    eye = torch.eye(k).expand(7, 12, k, k)
    for basis in (ft.u, ft.v):
        assert torch.allclose(basis @ basis.transpose(-1, -2), eye, atol=1e-5)
    want = np.sqrt(2.0 / (m + n)) * np.sqrt(k)
    assert abs(float(ft.s.std()) - want) < 0.1 * want
    assert abs(float(np.asarray(fj.s).std()) - want) < 0.1 * want
