"""Port parity: the PTC phase bridges and the forward dispatcher of
``repro_torch.core.ptc`` against ``repro.core.ptc``, on the same float32
numpy inputs (the suite runs jax in x64, so every input is cast to
float32 on both sides).

* ``factors_to_phases``: the same factors decomposed on both sides
  (numpy float64 per block, the same algorithm): phases and signs to
  1e-6, ``s`` passed through untouched.
* ``phases_to_factors``: the same phases realized on both sides (the
  reference's jitted mesh build, the port's mesh wrapper, whose plain
  version runs on a CPU tensor), without noise and with the quickstart's
  noise model on shared ``PhaseNoise`` draws: U and V to 1e-5.
* The round trip ``factors_to_phases`` then ``phases_to_factors``
  recomposes the weight to 1e-4 (the reference's own tolerance,
  ``tests/test_ptc.py``).
* ``ptc_forward`` in both modes to 1e-5; an unknown mode raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as jnoise, ptc as jptc
from repro_torch.core import noise as tnoise, ptc as tptc

# (M, N, k): a 2 x 1 grid of k = 9 (the quickstart's blocks) and a 4 x 3
# grid of k = 4 with padded edges
SHAPES = [(18, 9, 9), (14, 10, 4)]
KINDS = ["clements", "reck"]


def _factors(m, n, k, seed):
    """Orthogonal bases (QR of a Gaussian, float32) and singular values
    for a P x Q grid, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p, q = -(-m // k), -(-n // k)
    g = rng.standard_normal((2, p, q, k, k))
    qm, rm = np.linalg.qr(g)
    qm = qm * np.sign(np.diagonal(rm, axis1=-2, axis2=-1))[..., None, :]
    s = rng.uniform(0.1, 2.0, (p, q, k))
    return (qm[0].astype(np.float32), s.astype(np.float32),
            qm[1].astype(np.float32))


def _pair(u, s, v):
    """The same factors as a reference and a port ``PTCParams``."""
    return (jptc.PTCParams(u=jnp.asarray(u), s=jnp.asarray(s),
                           v=jnp.asarray(v)),
            tptc.PTCParams(u=torch.from_numpy(u), s=torch.from_numpy(s),
                           v=torch.from_numpy(v)))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_factors_to_phases_matches(kind, m, n, k):
    fj, ft = _pair(*_factors(m, n, k, seed=0))
    pj = jptc.factors_to_phases(fj, kind=kind)
    pt = tptc.factors_to_phases(ft, kind=kind)
    assert isinstance(pt, tptc.PTCPhaseParams)
    p, q = ft.grid
    t = k * (k - 1) // 2
    for name in ("phi_u", "d_u", "phi_v", "d_v"):
        got, want = getattr(pt, name), _np(getattr(pj, name))
        assert got.dtype == torch.float32
        assert got.shape == (p, q, t if name.startswith("phi") else k)
        np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                                   atol=1e-6, err_msg=name)
    assert pt.s is ft.s
    assert set(np.unique(pt.d_u.numpy())) <= {-1.0, 1.0}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_phases_to_factors_ideal_matches(kind, m, n, k):
    """No noise model, and a disabled one, give the ideal factors."""
    fj, _ = _pair(*_factors(m, n, k, seed=1))
    pj = jptc.factors_to_phases(fj, kind=kind)
    pt = tptc.PTCPhaseParams(*(torch.from_numpy(_np(a).astype(np.float32))
                               for a in pj))
    want = jptc.phases_to_factors(pj, kind=kind, model=None)
    for model in (None, tnoise.NoiseModel().off()):
        got = tptc.phases_to_factors(pt, kind=kind, model=model)
        assert got.s is pt.s
        for name in ("u", "v"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(),
                _np(getattr(want, name)).astype(np.float32), atol=1e-5,
                err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("frame", ["default", "post_ic"])
def test_phases_to_factors_noisy_matches(kind, frame):
    """The quickstart's noise model (8-bit Q, Γ, crosstalk, and the
    phase bias unless post-IC) on one set of draws handed to both."""
    m, n, k = 18, 18, 9
    model_j = {"default": jnoise.DEFAULT_NOISE,
               "post_ic": jnoise.DEFAULT_NOISE.post_ic()}[frame]
    model_t = {"default": tnoise.NoiseModel(),
               "post_ic": tnoise.NoiseModel().post_ic()}[frame]
    fj, _ = _pair(*_factors(m, n, k, seed=2))
    pj = jptc.factors_to_phases(fj, kind=kind)
    pt = tptc.PTCPhaseParams(*(torch.from_numpy(_np(a).astype(np.float32))
                               for a in pj))
    rng = np.random.default_rng(3)
    shape = tuple(pt.phi_u.shape)
    draws = [((1 + 0.002 * rng.standard_normal(shape)).astype(np.float32),
              rng.uniform(0, 2 * np.pi, shape).astype(np.float32))
             for _ in range(2)]
    nj = [jnoise.PhaseNoise(jnp.asarray(g), jnp.asarray(b)) for g, b in draws]
    nt = [tnoise.PhaseNoise(torch.from_numpy(g), torch.from_numpy(b))
          for g, b in draws]
    want = jptc.phases_to_factors(pj, nj[0], nj[1], kind=kind, model=model_j)
    got = tptc.phases_to_factors(pt, nt[0], nt[1], kind=kind, model=model_t)
    ideal = tptc.phases_to_factors(pt, kind=kind)
    for name in ("u", "v"):
        g, w = getattr(got, name).numpy(), _np(getattr(want, name))
        np.testing.assert_allclose(g, w.astype(np.float32), atol=1e-5,
                                   err_msg=name)
        # the noise moved the realization off the ideal one
        assert np.abs(g - getattr(ideal, name).numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="noise"):
        tptc.phases_to_factors(pt, kind=kind, model=model_t)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_round_trip_recomposes_the_weight(kind, m, n, k):
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((m, n)) * 0.3).astype(np.float32)
    f = tptc.svd_factorize(torch.from_numpy(w), k)
    f2 = tptc.phases_to_factors(tptc.factors_to_phases(f, kind=kind),
                                kind=kind, model=None)
    w2 = tptc.unblockize(tptc.compose_weight(f2), m, n)
    np.testing.assert_allclose(w2.numpy(), w, atol=1e-4)
    # the reference's round trip of the same weight lands on the same W
    fj = jptc.svd_factorize(jnp.asarray(w), k)
    wj = jptc.unblockize(jptc.compose_weight(jptc.phases_to_factors(
        jptc.factors_to_phases(fj, kind=kind), kind=kind, model=None)), m, n)
    np.testing.assert_allclose(w2.numpy(), _np(wj).astype(np.float32),
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["fused", "blocked"])
@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("out_dim", [None, 5])
def test_ptc_forward_matches(mode, m, n, k, out_dim):
    fj, ft = _pair(*_factors(m, n, k, seed=5))
    x = np.random.default_rng(6).standard_normal((3, 2, n)).astype(np.float32)
    want = jptc.ptc_forward(fj, jnp.asarray(x), mode=mode, out_dim=out_dim)
    got = tptc.ptc_forward(ft, torch.from_numpy(x), mode=mode,
                           out_dim=out_dim)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), _np(want).astype(np.float32),
                               atol=1e-5)


def test_ptc_forward_unknown_mode_raises():
    fj, ft = _pair(*_factors(9, 9, 9, seed=7))
    x = np.zeros((2, 9), np.float32)
    with pytest.raises(ValueError, match="unknown ptc forward mode"):
        jptc.ptc_forward(fj, jnp.asarray(x), mode="dense")
    with pytest.raises(ValueError, match="unknown ptc forward mode"):
        tptc.ptc_forward(ft, torch.from_numpy(x), mode="dense")
