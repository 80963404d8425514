"""Port parity: ``repro_torch.optim.zo`` against ``repro.optim.zo``.

A per-block quadratic, six blocks searched at once.  The reference
``jax.vmap``s one search per block; the port keeps all blocks in one
(B, n) tensor.  Both consume the same draws: the test makes them with
``jax.random`` exactly as ``zo.py`` does (per block, ``split(key, steps)``
then ``randint`` or ``normal`` per step) and injects them into the port.
The suite runs JAX with x64 on, so the reference's step sizes and normal
draws are float64 (its ztp / zgd need a float64 start point to keep one
carry type); the port computes in float32.  Results agree to float32
precision: 1e-4 relative on the final loss and 1e-4 absolute on the
solution.  A ZCD branch could in principle flip on a near-tie, which these
well-separated quadratics avoid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import zo as jzo
from repro_torch import convert
from repro_torch.optim import zo as tzo

B, N = 6, 8
CFG = jzo.ZOConfig(steps=60, inner=7, delta0=0.3, decay=1.2,
                   delta_min=0.01, lr0=0.2, record_every=10)


def _problem():
    rng = np.random.default_rng(0)
    c = rng.uniform(-1, 1, (B, N)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (B, N)).astype(np.float32)
    x0 = rng.uniform(-1, 1, (B, N)).astype(np.float32)
    return c, w, x0


def _jax_draws(keys, method, alt_split):
    """The per-step draws zo.py makes from each block's key."""
    def block(key):
        ks = jax.random.split(key, CFG.steps)
        if method == "zcd":
            hi = N if alt_split is None else 1 << 30
            return jax.vmap(lambda kt: jax.random.randint(kt, (), 0, hi))(ks)
        return jax.vmap(lambda kt: jax.random.normal(kt, (N,)))(ks)
    return np.asarray(jax.vmap(block)(keys))


@pytest.mark.parametrize("method,alt_split", [("zcd", None), ("zcd", 3),
                                              ("ztp", None), ("zgd", None)])
def test_zo_minimize_matches_reference_under_shared_draws(method, alt_split):
    c, w, x0 = _problem()
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    def jloss(x, cb, wb):
        return jnp.sum(wb * (x - cb) ** 2)

    x0_j = x0 if method == "zcd" else x0.astype(np.float64)
    res_j = jax.vmap(lambda x, k, cb, wb: jzo.zo_minimize(
        lambda xx: jloss(xx, cb, wb), x, k, CFG, method, alt_split))(
            jnp.asarray(x0_j), keys, jnp.asarray(c), jnp.asarray(w))

    ct, wt = torch.from_numpy(c), torch.from_numpy(w)
    draws = torch.as_tensor(np.array(_jax_draws(keys, method, alt_split)))
    res_t = tzo.zo_minimize(lambda x: torch.sum(wt * (x - ct) ** 2, dim=-1),
                            torch.from_numpy(x0), convert.zo_config(CFG),
                            method, alt_split, draws=draws)

    f_j = np.asarray(res_j.f, np.float64)
    assert res_t.f.shape == (B,) and res_t.x.shape == (B, N)
    assert res_t.history.shape == np.asarray(res_j.history).shape == \
        (B, CFG.steps // CFG.record_every)
    np.testing.assert_allclose(res_t.f.numpy(), f_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x),
                               atol=1e-4)
    np.testing.assert_allclose(res_t.history.numpy(),
                               np.asarray(res_j.history), rtol=1e-4,
                               atol=1e-6)
    # the search made progress and never lost its best point
    f0 = np.sum(w * (x0 - c) ** 2, axis=-1)
    assert np.all(res_t.f.numpy() <= f0 + 1e-6)
    assert np.all(np.diff(res_t.history.numpy(), axis=-1) <= 1e-7)


def test_zo_minimize_draws_from_a_generator():
    """Without injected draws the port draws from ``gen``: reproducible per
    seed, and the alternate split keeps odd steps in [split, n)."""
    c, w, x0 = _problem()
    ct, wt = torch.from_numpy(c), torch.from_numpy(w)
    seen = []

    def loss(x):
        seen.append(x.clone())
        return torch.sum(wt * (x - ct) ** 2, dim=-1)

    cfg = convert.zo_config(CFG)
    runs = [tzo.zo_minimize(loss, torch.from_numpy(x0), cfg, "zcd", 3,
                            gen=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(runs[0].x, runs[1].x)
    # loss call 2t holds step t's start point and call 2t + 1 its probe
    for t in (0, 1, 2, 3):
        changed = (seen[2 * t + 1] != seen[2 * t]).nonzero()[:, 1]
        assert bool(((changed < 3) if t % 2 == 0 else (changed >= 3)).all())
    with pytest.raises(ValueError):
        tzo.zo_minimize(loss, torch.from_numpy(x0), cfg)
