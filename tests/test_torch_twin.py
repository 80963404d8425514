"""Port parity: ``repro_torch.hw`` (TwinDriver, jobs) against ``repro.hw``.

One device realization, sampled by the reference and carried across with
``repro_torch.convert``, backs both twins.  Both get the same commanded
state (fp32 numpy).  Probes, serve forwards and readbacks agree to 1e-5
absolute (fp32 meshes and k-term sums; the reference's twin uses its
einsum path on a CPU, the port its plain PTC / mesh versions).  The PTC
meter must agree exactly.  The in-situ jobs get the per-step draws the
reference makes with ``jax.random`` and are compared by final loss per
block, to 1e-3 relative: the reference's IC search runs in float64 under
the suite's x64 setting and the port in fp32, so a ZCD comparison could
flip on a near-tie; with these seeds none does and the losses agree to
about 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.core import calibration as jcal
from repro.core.noise import DEFAULT_NOISE
from repro.hw.device import chip_forward as j_chip_forward  # repro: noqa[RPL103]
from repro.hw.device import sample_device as j_sample_device
from repro.optim.zo import ZOConfig
from repro_torch import convert
from repro_torch.core import unitary as tun
from repro_torch.hw import make_twin, readout_blocks
from repro_torch.hw.device import chip_forward  # repro: noqa[RPL103]

K, P, Q = 4, 2, 3
B = P * Q
M, N = 7, 11        # ragged: padded to the 8 × 12 block grid


@pytest.fixture(scope="module")
def twins():
    model = DEFAULT_NOISE
    dev_j = j_sample_device(jax.random.PRNGKey(3), (B,), K, model)
    jt = jhw.make_twin(jax.random.PRNGKey(3), B, K, model, m=M, n=N,
                       dev=dev_j)
    tt = make_twin(None, B, K, convert.noise_model(model), m=M, n=N,
                   dev=convert.device_realization(dev_j), device="cpu")
    rng = np.random.default_rng(0)
    t = K * (K - 1) // 2
    phi_u, phi_v = (rng.uniform(-np.pi, np.pi, (B, t)).astype(np.float32)
                    for _ in range(2))
    sigma = rng.uniform(0.2, 1.5, (B, K)).astype(np.float32)
    d_u, d_v = (rng.choice([-1.0, 1.0], (B, K)).astype(np.float32)
                for _ in range(2))
    for drv, conv in ((jt, jnp.asarray), (tt, torch.from_numpy)):
        drv.write_signs(conv(d_u), conv(d_v))
        drv.write_phases(conv(phi_u), conv(phi_v))
        drv.write_sigma(conv(sigma))
    return jt, tt, dev_j


def _close(t, j, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32),
                               atol=atol)


def test_commanded_state_carried_across(twins):
    jt, tt, _ = twins
    phi, sigma = convert.commanded_state(jt)
    tphi = torch.cat(tt.read_phases(), dim=-1)
    assert torch.equal(tphi, phi) and torch.equal(tt.read_sigma(), sigma)
    assert (tt.k, tt.kind, tt.n_blocks, tt.layer_shape) == \
        (jt.k, jt.kind, jt.n_blocks, jt.layer_shape)


def test_probes_readbacks_and_meter_match(twins):
    jt, tt, _ = twins
    jt.reset_stats()
    tt.reset_stats()
    x = np.random.default_rng(1).standard_normal((5, K)).astype(np.float32)
    _close(tt.forward(torch.from_numpy(x)), jt.forward(jnp.asarray(x)))
    _close(tt.forward(torch.from_numpy(x), block_range=(1, 4)),
           jt.forward(jnp.asarray(x), block_range=(1, 4)))
    _close(readout_blocks(tt, category="probe"),
           jhw.driver.readout_blocks(jt, category="probe"))
    xs = np.random.default_rng(2).standard_normal((2, 3, N)).astype(
        np.float32)
    y_t = tt.forward_layer(torch.from_numpy(xs))
    _close(y_t, jt.forward_layer(jnp.asarray(xs)))
    # the plain einsum over the realized blocks gives the same serve forward
    phi, sigma = convert.commanded_state(jt)
    y_plain = chip_forward(tun.mesh_spec(K, "clements"), phi, sigma,
                           tt._dev, tt._model, torch.from_numpy(xs), M)
    _close(y_plain, j_chip_forward(jt._spec, jnp.asarray(phi.numpy()),
                                   jnp.asarray(sigma.numpy()),
                                   jt._state.dev, jt._model,
                                   jnp.asarray(xs), M))
    _close(y_t, y_plain.numpy())
    # one tenant's sub-grid: blocks [3, 6) as a 1 × 3 grid of out_dim 4
    _close(tt.forward_layer(torch.from_numpy(xs[0]), block_range=(3, 6),
                            out_dim=4),
           jt.forward_layer(jnp.asarray(xs[0]), block_range=(3, 6),
                            out_dim=4))
    for cols in (None, [0, 2]):
        ut, vt = tt.readback_bases(cols)
        uj, vj = jt.readback_bases(cols)
        _close(ut, uj)
        _close(vt, vj)
    tt.charge("probe", 3.0)
    jt.charge("probe", 3.0)
    assert tt.stats.as_dict() == jt.stats.as_dict()
    assert tt.stats.total > 0
    with pytest.raises(ValueError):
        tt.charge("light", 1.0)


def test_run_ic_under_injected_draws(twins):
    _, _, dev_j = twins
    model = DEFAULT_NOISE
    cfg = ZOConfig(steps=40, inner=12, delta0=0.5, decay=1.05)
    restarts, key = 2, jax.random.PRNGKey(9)
    sigs = jcal.calibration_sigma(K)
    jt = jhw.make_twin(key, B, K, model, dev=dev_j)
    rj = jt.run_ic(key, sigs, cfg, restarts=restarts)
    # the draws ic_search and zo_minimize make from ``key``
    n = K * (K - 1)
    draws = np.stack([np.asarray(jax.vmap(lambda kb: jax.vmap(
        lambda kt: jax.random.randint(kt, (), 0, n))(
            jax.random.split(kb, cfg.steps)))(
        jax.random.split(jax.random.fold_in(key, r), B)))
        for r in range(restarts)])
    tt = make_twin(None, B, K, convert.noise_model(model),
                   dev=convert.device_realization(dev_j), device="cpu")
    rt = tt.run_ic(None, convert.tensor(sigs),
                   convert.zo_config(cfg), restarts=restarts,
                   draws=torch.as_tensor(draws))
    assert rt.loss.shape == (B,) and rt.phi.shape == (B, n)
    assert rt.history.shape == np.asarray(rj.history).shape
    np.testing.assert_allclose(rt.loss.numpy(), np.asarray(rj.loss),
                               rtol=1e-3)
    assert float(rt.loss.mean()) < float(rt.history[:, 0].mean())
    assert tt.stats.as_dict() == jt.stats.as_dict()
    # the readback is the realized state of the written phases
    ur, vr = tt.readback_bases()
    assert torch.allclose(ur, rt.u) and torch.allclose(vr, rt.v)


def test_zo_refine_under_injected_draws(twins):
    jt, tt, _ = twins
    jt.reset_stats()
    tt.reset_stats()
    w = np.random.default_rng(4).standard_normal((B, K, K)).astype(np.float32)
    cfg = ZOConfig(steps=30, inner=8, delta0=2 * np.pi / 255 * 8)
    key = jax.random.PRNGKey(11)
    rj = jt.zo_refine(jnp.asarray(w), key, cfg)
    draws = np.array(jax.vmap(lambda kb: jax.vmap(
        lambda kt: jax.random.randint(kt, (), 0, 1 << 30))(
            jax.random.split(kb, cfg.steps)))(jax.random.split(key, B)))
    rt = tt.zo_refine(torch.from_numpy(w), None, convert.zo_config(cfg),
                      draws=torch.as_tensor(draws))
    np.testing.assert_allclose(rt.loss.numpy(), np.asarray(rj.loss),
                               rtol=1e-3)
    assert rt.steps == rj.steps == cfg.steps
    assert tt.stats.as_dict() == jt.stats.as_dict()
    assert torch.equal(torch.cat(tt.read_phases(), dim=-1), rt.phi)


@pytest.mark.parametrize("by", ["gen", "draws"])
@pytest.mark.parametrize("k, kind", [(4, "clements"), (8, "clements"),
                                     (5, "reck")])
def test_zcd_phase_refine_is_zo_minimize_bit_for_bit(k, kind, by):
    """``phase_refine``'s ZCD realizes only the moved half's unitary at each
    measurement; ``zo_minimize`` on the whole loss gives the same bits."""
    from repro_torch.core.noise import DEFAULT_NOISE as T_NOISE
    from repro_torch.hw import jobs
    from repro_torch.hw.device import realized_unitaries, sample_device
    from repro_torch.optim.zo import ZOConfig as TZOConfig, zo_minimize

    gen = torch.Generator().manual_seed(k)
    spec = tun.mesh_spec(k, kind)
    t, b = spec.n_rot, 6
    dev = sample_device(gen, (b,), k, T_NOISE, kind)
    phi0 = torch.rand((b, 2 * t), generator=gen) * 6.28
    sigma = torch.rand((b, k), generator=gen) + 0.5
    w = torch.randn((b, k, k), generator=gen)
    cfg = TZOConfig(steps=40, inner=6, delta0=0.05, decay=1.05,
                    record_every=7)

    def loss(ph):
        u, v = realized_unitaries(spec, ph[:, :t], ph[:, t:], dev, T_NOISE)  # repro: noqa[RPL103]
        return jobs._block_distance(jobs.probe_transfer(u, sigma, v), w)

    def src():
        if by == "gen":
            return dict(gen=torch.Generator().manual_seed(7))
        return dict(draws=jobs.job_draws(torch.Generator().manual_seed(7),
                                         "zcd", b, cfg.steps, t))

    s = src()
    got = jobs.phase_refine(spec, T_NOISE, dev, phi0, sigma, w, s.get("gen"),
                            cfg, "zcd", s.get("draws"))
    want = zo_minimize(loss, phi0, cfg, "zcd", alt_split=t, **src())
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    assert not torch.equal(got.x, phi0)
