"""Port parity: ``repro_torch.hw`` drift, the batched op lists, the twin's
escape hatch and ``make_driver`` against ``repro.hw``.

One device realization, sampled by the reference and carried across with
``repro_torch.convert``, backs both sides, cast to float32 (the suite runs
JAX in x64).  ``advance`` gets the reference's own normal draws,
re-derived with ``jax.random`` in ``_advance``'s split order (bias_u,
bias_v, gamma_u, gamma_v), and must land within 1e-6 (fp32 arithmetic on
biases up to 2π).  The exact mapping distance agrees to 1e-5 relative.
``forward_many`` and the coalescing ``run_batch`` must equal separate
``forward`` calls bit for bit, with the same meter.
"""

import jax
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.core.noise import DEFAULT_NOISE
from repro.hw import drift as jdrift
from repro.hw.device import sample_device as j_sample_device
from repro_torch import convert, hw
from repro_torch.hw import drift as tdrift

K, B = 4, 6
DRIFT = jdrift.DriftConfig(sigma_phase=0.03, theta=0.05, sigma_gamma=0.002,
                           aging=0.001)


def _f32(a):
    return np.asarray(a, np.float32)


def _ref_state(seed=3):
    dev = j_sample_device(jax.random.PRNGKey(seed), (B,), K, DEFAULT_NOISE)
    dev = jax.tree_util.tree_map(lambda a: jax.numpy.asarray(a, "float32"),
                                 dev)
    return jdrift.init_drift(dev)


def _ref_eps(key, shape):
    """The four draws ``_advance`` makes from ``key``, in its order."""
    return [_f32(jax.random.normal(k, shape))
            for k in jax.random.split(key, 4)]


@pytest.mark.parametrize("sigma_gamma", [0.0, 0.002])
def test_advance_matches_reference_under_its_draws(sigma_gamma):
    cfg_j = DRIFT._replace(sigma_gamma=sigma_gamma)
    cfg_t = convert.drift_config(cfg_j)
    st_j = _ref_state()
    st_t = convert.drift_state(st_j)
    shape = st_t.dev.noise_u.bias.shape
    for step in range(6):
        key = jax.random.fold_in(jax.random.PRNGKey(11), step)
        st_j = jdrift.advance(st_j, 1.0, key, cfg_j)
        eps = [torch.from_numpy(e) for e in _ref_eps(key, shape)]
        st_t = tdrift.advance(st_t, 1.0, cfg=cfg_t, eps=eps)
        for a_t, a_j in ((st_t.dev.noise_u.bias, st_j.dev.noise_u.bias),
                         (st_t.dev.noise_v.bias, st_j.dev.noise_v.bias),
                         (st_t.dev.noise_u.gamma, st_j.dev.noise_u.gamma),
                         (st_t.dev.noise_v.gamma, st_j.dev.noise_v.gamma)):
            np.testing.assert_allclose(a_t.numpy(), _f32(a_j), atol=1e-6)
        assert st_t.t == float(st_j.t) == step + 1.0
    # the anchor and the signs never move
    for a_t, a_j in ((st_t.anchor.noise_u.bias, st_j.anchor.noise_u.bias),
                     (st_t.dev.d_u, st_j.dev.d_u),
                     (st_t.dev.d_v, st_j.dev.d_v)):
        np.testing.assert_array_equal(a_t.numpy(), _f32(a_j))
    np.testing.assert_allclose(float(tdrift.bias_deviation(st_t)),
                               float(jdrift.bias_deviation(st_j)), rtol=1e-5)
    assert float(tdrift.bias_deviation(st_t)) > 0.0
    with pytest.raises(ValueError):
        tdrift.advance(st_t, 1.0)


@pytest.mark.parametrize("sigma_gamma", [0.0, 0.002])
def test_advance_at_sigma_phase_zero_keeps_the_bits(sigma_gamma):
    """At σ_phase = 0 the bias term is exactly zero, so ``advance`` skips
    the bias draws (both σ zero: no draw at all): N ticks through a
    generator and through ``eps`` give the realization of the walk that
    draws them and scales them by zero; with σ_γ ≠ 0 all four draws are
    still made, in their order."""
    cfg = convert.drift_config(DRIFT._replace(sigma_phase=0.0,
                                              sigma_gamma=sigma_gamma))
    start = convert.drift_state(_ref_state())
    shape = start.dev.noise_u.bias.shape
    g_skip, g_draw = torch.Generator().manual_seed(4), \
        torch.Generator().manual_seed(4)
    st_gen = st_eps = st_draw = start
    for _ in range(5):
        st_gen = tdrift.advance(st_gen, 1.0, g_skip, cfg)
        eps = [torch.randn(shape, generator=g_draw)
               for _ in range(4 if sigma_gamma else 2)]
        st_eps = tdrift.advance(st_eps, 1.0, cfg=cfg, eps=eps)
        # the drawing walk: every term through _ou_step, the bias ones
        # scaled by σ_phase = 0
        a, d = st_draw.anchor, st_draw.dev
        ramp = cfg.aging * st_draw.t
        bias = [tdrift._ou_step(dn.bias, an.bias + ramp, cfg.theta, 0.0,
                                1.0, e)
                for dn, an, e in zip((d.noise_u, d.noise_v),
                                     (a.noise_u, a.noise_v), eps)]
        if sigma_gamma:
            gamma = [tdrift._ou_step(dn.gamma, an.gamma, cfg.theta,
                                     cfg.sigma_gamma, 1.0, e)
                     for dn, an, e in zip((d.noise_u, d.noise_v),
                                          (a.noise_u, a.noise_v), eps[2:])]
        else:
            gamma = [dn.gamma + cfg.theta * (an.gamma - dn.gamma) * 1.0
                     for dn, an in zip((d.noise_u, d.noise_v),
                                       (a.noise_u, a.noise_v))]
        st_draw = tdrift.DriftState(
            anchor=a, t=st_draw.t + 1.0,
            dev=d._replace(noise_u=d.noise_u._replace(gamma=gamma[0],
                                                      bias=bias[0]),
                           noise_v=d.noise_v._replace(gamma=gamma[1],
                                                      bias=bias[1])))
        for st in (st_gen, st_eps):
            for got, want in zip(
                    (st.dev.noise_u.bias, st.dev.noise_v.bias,
                     st.dev.noise_u.gamma, st.dev.noise_v.gamma),
                    (bias[0], bias[1], gamma[0], gamma[1])):
                assert torch.equal(got, want)
    assert float(tdrift.bias_deviation(st_gen)) > 0.0       # aging moves it
    # no bias draw was made from the generator without Γ diffusion
    want_state = torch.Generator().manual_seed(4)
    for _ in range(5 * (4 if sigma_gamma else 0)):
        torch.randn(shape, generator=want_state)
    assert torch.equal(g_skip.get_state(), want_state.get_state())


def test_twin_drift_chain_is_seeded_and_device_owned():
    model = convert.noise_model(DEFAULT_NOISE.post_ic())
    cfg = convert.drift_config(DRIFT)

    def walk(seed, ticks=5, drift=cfg):
        drv = hw.make_twin(torch.Generator().manual_seed(seed), B, K, model,
                           drift=drift, device="cpu")
        h = drv.unsafe_twin()
        d0 = h.dev
        for _ in range(ticks):
            drv.advance(1.0)
        return h, d0

    (h1, d0), (h2, _), (h3, _) = walk(0), walk(0), walk(1)
    assert torch.equal(h1.dev.noise_u.bias, h2.dev.noise_u.bias)
    assert not torch.equal(h1.dev.noise_u.bias, h3.dev.noise_u.bias)
    assert h1.drift_state.t == 5.0 and h1.bias_deviation() > 0.0
    assert torch.equal(h1.anchor.noise_u.bias, d0.noise_u.bias)
    assert torch.equal(h1.dev.d_u, d0.d_u)
    # no drift config: time passes without effect; the realization drawn
    # from the generator is the same with or without drift
    h0, d00 = walk(0, drift=None)
    assert torch.equal(h0.dev.noise_u.bias, d00.noise_u.bias)
    assert torch.equal(d00.noise_u.gamma, d0.noise_u.gamma)
    assert h0.bias_deviation() == 0.0


@pytest.fixture(scope="module")
def pair():
    """A reference twin and a port twin on one carried realization and
    commanded state, both drifted one step by the reference's walk."""
    rng = np.random.default_rng(0)
    st_j = jdrift.advance(_ref_state(5), 1.0, jax.random.PRNGKey(2), DRIFT)
    model = DEFAULT_NOISE.post_ic()
    jt = jhw.make_twin(jax.random.PRNGKey(5), B, K, model, m=K, n=K * B,
                       dev=st_j.anchor)
    jt._state = st_j
    tt = hw.make_twin(None, B, K, convert.noise_model(model), m=K, n=K * B,
                      dev=st_j.anchor, device="cpu")
    tt._state = convert.drift_state(st_j)
    t = K * (K - 1) // 2
    phi_u, phi_v = (rng.uniform(-np.pi, np.pi, (B, t)).astype(np.float32)
                    for _ in range(2))
    sigma = rng.uniform(0.2, 1.5, (B, K)).astype(np.float32)
    for drv, conv in ((jt, jax.numpy.asarray), (tt, torch.from_numpy)):
        drv.write_phases(conv(phi_u), conv(phi_v))
        drv.write_sigma(conv(sigma))
    w = rng.standard_normal((B, K, K)).astype(np.float32)
    return jt, tt, w


def test_true_mapping_distance_matches_reference(pair):
    jt, tt, w = pair
    hj, ht = jt.unsafe_twin(), tt.unsafe_twin()
    np.testing.assert_allclose(ht.true_mapping_distance(torch.from_numpy(w)),
                               hj.true_mapping_distance(w), rtol=1e-5)
    np.testing.assert_allclose(
        ht.true_mapping_distance(torch.from_numpy(w[2:5]), (2, 5)),
        hj.true_mapping_distance(w[2:5], (2, 5)), rtol=1e-5)
    np.testing.assert_allclose(ht.realized_blocks().numpy(),
                               _f32(hj.realized_blocks()), atol=1e-5)
    for a_t, a_j in zip(ht.realized_unitaries(), hj.realized_unitaries()):
        np.testing.assert_allclose(a_t.numpy(), _f32(a_j), atol=1e-5)
    np.testing.assert_allclose(ht.bias_deviation(), hj.bias_deviation(),
                               rtol=1e-5)


def test_forward_many_and_run_batch_equal_separate_forwards(pair):
    _, tt, _ = pair
    gen = torch.Generator().manual_seed(4)
    xs = [torch.randn((6, K), generator=gen) for _ in range(30)]
    tt.reset_stats()
    single = [tt.forward(x) for x in xs]
    s_single = tt.stats.as_dict()
    tt.reset_stats()
    many = tt.forward_many(xs)
    assert tt.stats.as_dict() == s_single
    assert all(torch.equal(a, b) for a, b in zip(many, single))
    stacked = tt.forward_many_stacked(torch.stack(xs), block_range=(1, 4))
    assert stacked.shape == (30, 3, 6, K)
    assert all(torch.equal(stacked[i], tt.forward(x, block_range=(1, 4)))
               for i, x in enumerate(xs))

    # a mixed list: coalesced spans between writes and other ops
    ops = [("forward", dict(x=xs[0])), ("forward", dict(x=xs[1])),
           ("stats", {}), ("read_sigma", {}),
           ("forward", dict(x=xs[2], block_range=(0, 2))),
           ("forward", dict(x=xs[3], block_range=(0, 2))),
           ("forward", dict(x=xs[4][:3])),
           ("charge", dict(category="search", calls=2.0)),
           ("forward_layer", dict(x=torch.ones((2, K * B))))]
    tt.reset_stats()
    batched = tt.run_batch(ops)
    s_batched = tt.stats.as_dict()
    tt.reset_stats()
    seq = hw.PhotonicDriver.run_batch(tt, ops)      # one op at a time
    assert tt.stats.as_dict() == s_batched
    assert len(batched) == len(seq) == len(ops)
    for a, b in zip(batched, seq):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(a, hw.DriverStats):
            assert a.as_dict() == b.as_dict()
    assert batched[2].total == 2.0 * B * 6
    fut = tt.run_batch_async(ops[:2])
    assert fut.done() and all(torch.equal(a, b) for a, b in
                              zip(fut.result(), single[:2]))
    for bad in (("close", {}), ("unsafe_twin", {}), ("forward_many", {}),
                ("forward", dict(x=xs[0], category="light"))):
        with pytest.raises(ValueError):
            tt.run_batch([ops[0], bad])
    tt.flush()
    with tt as same:
        assert same is tt


def test_batch_surface_and_coalescing_rule_match_reference():
    from repro.hw import driver as jdrv
    from repro_torch.hw import driver as tdrv
    assert tdrv.BATCHABLE_OPS == jdrv.BATCHABLE_OPS
    assert tdrv.WIRE_INTERNAL_OPS == jdrv.WIRE_INTERNAL_OPS
    assert tdrv.STAT_CATEGORIES == jdrv.STAT_CATEGORIES
    x = np.zeros((6, K), np.float32)
    kws = [dict(x=x), dict(x=torch.from_numpy(x)), dict(x=x[:2]),
           dict(x=x, block_range=(1, 3)), dict(x=x, category="serve")]
    for kw in kws:
        assert tdrv.forward_coalesce_key(kw) == jdrv.forward_coalesce_key(kw)
    for keys in ([], [None], [1, 1, None, 2, 2, 2, 1], [None, None, 3, 3]):
        assert tdrv.coalesce_spans(keys) == jdrv.coalesce_spans(keys)


def test_make_driver_and_package_surface():
    model = convert.noise_model(DEFAULT_NOISE.post_ic())
    drv = hw.make_driver("twin", torch.Generator().manual_seed(0), B, K,
                         model, drift=hw.DEFAULT_DRIFT, device="cpu")
    assert isinstance(drv, hw.TwinDriver) and drv.n_blocks == B
    assert isinstance(drv.unsafe_twin(), hw.TwinHandle)
    # the stream transports sample the twin the in-process one does, from
    # one wire key drawn from the generator
    twin = hw.make_driver("twin", torch.Generator().manual_seed(5), B, K,
                          model, drift=hw.DEFAULT_DRIFT, device="cpu")
    for transport, cls in (("subprocess", hw.SubprocessDriver),
                           ("socket", hw.SocketDriver)):
        with hw.make_driver(transport, torch.Generator().manual_seed(5), B,
                            K, model, drift=hw.DEFAULT_DRIFT,
                            device="cpu") as remote:
            assert isinstance(remote, cls) and remote.n_blocks == B
            dev = remote.unsafe_twin().dev
            for a, b in zip(jax.tree_util.tree_leaves(tuple(dev)),
                            jax.tree_util.tree_leaves(
                                tuple(twin.unsafe_twin().dev))):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown"):
        hw.make_driver("carrier-pigeon", None, B, K, model, device="cpu")
    assert tuple(hw.DEFAULT_DRIFT) == tuple(jhw.DEFAULT_DRIFT)
    assert hw.DriftConfig._fields == jhw.DriftConfig._fields

    class Opaque(hw.TwinDriver):
        unsafe_twin = hw.PhotonicDriver.unsafe_twin

    with pytest.raises(hw.TwinUnavailable):
        Opaque(drv.unsafe_twin().dev, K, model, device="cpu").unsafe_twin()
