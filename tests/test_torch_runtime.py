"""Port parity: ``repro_torch.runtime`` (monitor, recalibrate, fleet, demo)
against ``repro.runtime``, at the reference demo's geometry (k = 4, dim 12,
three tenants a chip).

The reference fleet is built once (module fixture) and carried across with
``convert.fleet``: drift states, commanded state, meters, tenants.  Every
comparison casts to float32 (the suite runs JAX in x64, the port fp32):

* the monitor's estimators and ``score_tenant_probes`` on the same probe
  columns within 1e-5 relative;
* the hysteresis, ``autotune_zo_steps``, ``predicted_distance`` and the
  dispatch / ``route_pass`` choices under all three policies exactly;
* ``recalibrate``'s OSP and Σ-descent stages (no ZO steps, the reference's
  Σ-descent probe columns injected) within 1e-5;
* the lockstep fleet: each tick the reference's drifted realization is
  carried into the port's twins and the reference's probe columns are
  injected; the event timeline must be identical and every true distance
  and served batch within 1e-5 relative up to the first ``recal_done``
  (the recal's ZO searches draw their own coordinates and may part);
* ``simulate`` / ``main`` at the reference's fast smoke meet the
  reference's own exit criteria; the router never dispatches to a
  RECALIBRATING or offline chip; partial recal leaves co-tenants
  bit-identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # optional dev extra; fall back to the shim
    from _hypothesis_shim import given, settings, strategies as st

from repro.runtime import demo as jdemo
from repro.runtime import fleet as jfleet
from repro.runtime import monitor as jmon
from repro.runtime.recalibrate import (RecalConfig as JRecalConfig,
                                       autotune_zo_steps as j_autotune,
                                       recalibrate as j_recalibrate)
from repro_torch import convert
from repro_torch.benchmarks import drift_recovery, run as bench_run
from repro_torch.runtime import demo as tdemo
from repro_torch.runtime import fleet as tfleet
from repro_torch.runtime import monitor as tmon
from repro_torch.runtime.recalibrate import (RecalConfig, autotune_zo_steps,
                                             recalibrate)

K, DIM, TENANTS = 4, 12, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMOKE = ["--chips", "2", "--steps", "40", "--dim", "12", "--k", "4",
         "--probe-every", "5", "--sigma-drift", "0.04", "--device", "cpu"]


def _f32(a):
    return np.asarray(a, np.float32)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _ref_cfg(**kw):
    return jdemo.default_runtime_config(k=K, sigma_drift=0.04,
                                        probe_every=5, **kw)


@pytest.fixture(scope="module")
def ref_fleet():
    """The reference's 2-chip, 3-tenant fleet, freshly deployed, with its
    weights; a small ZO budget keeps the reference's first repair cheap."""
    cfg = _ref_cfg(zo_steps=48)
    ws = jdemo._make_weights(jax.random.PRNGKey(0), DIM, TENANTS)
    chips = jfleet.make_fleet(jax.random.PRNGKey(1), 2, ws, cfg)
    return cfg, ws, chips


def _carry(chips, cfg):
    return convert.fleet(chips, convert.runtime_config(cfg), device="cpu")


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------


def test_monitor_estimators_match_reference(ref_fleet):
    cfg, _, chips = ref_fleet
    jc = chips[0]
    st0 = jc.driver.unsafe_twin().drift_state
    for _ in range(25):                  # a drifted chip (reference walk)
        jc.driver.advance(1.0)
    tc = _carry([jc], cfg)[0]
    try:
        rng = np.random.default_rng(3)
        x = rng.standard_normal((6, K)).astype(np.float32)
        tx = torch.from_numpy(x)
        for t_j, t_t in zip(jc.tenants, tc.tenants):
            br = t_j.block_range
            got = tmon.probe_mapping_distance(None, tc.driver, t_t.w_blocks,
                                              6, br, x=tx)
            # the reference draws its columns from a key: score them alike
            y = jc.driver.forward(jax.numpy.asarray(x), block_range=br)
            ref = jmon.score_tenant_probes(
                jax.numpy.asarray(x), y, [((0, br[1] - br[0]), t_j.w_blocks)])
            assert _rel(float(got), float(ref[0])) < 1e-5
            assert _rel(float(tmon.readout_mapping_distance(
                tc.driver, t_t.w_blocks, br)), float(
                jmon.readout_mapping_distance(jc.driver, t_j.w_blocks,
                                              br))) < 1e-5
        y_j = jc.driver.forward(jax.numpy.asarray(x))
        specs_j = [(t.block_range, t.w_blocks) for t in jc.tenants]
        specs_t = [(t.block_range, t.w_blocks) for t in tc.tenants]
        got = tmon.probe_tenant_distances(None, tc.driver, specs_t, 6, x=tx)
        ref = jmon.score_tenant_probes(jax.numpy.asarray(x), y_j, specs_j)
        scored = tmon.score_tenant_probes(
            tx, torch.from_numpy(_f32(y_j)), specs_t)
        for a, b, c in zip(got, ref, scored):
            assert _rel(float(a), float(b)) < 1e-5
            assert _rel(float(c), float(b)) < 1e-5
        np.testing.assert_allclose(
            tmon.aggregate_distance(torch.ones(2, K, K), torch.eye(K).expand(
                2, K, K)).item(),
            float(jmon.aggregate_distance(np.ones((2, K, K)),
                                          np.broadcast_to(np.eye(K),
                                                          (2, K, K)))),
            rtol=1e-6)
        # identity probe: the full branch and a partial one on given columns
        for n, cols in ((K, None), (2, [3, 1])):
            got = tmon.probe_identity_distance(
                None, tc.driver, n,
                cols=None if cols is None else torch.tensor(cols))
            key = jax.random.PRNGKey(0)
            if cols is not None:          # the columns the key would choose
                key = _key_choosing(cols)
            ref = jmon.probe_identity_distance(key, jc.driver, n)
            assert _rel(float(got), float(ref)) < 1e-5
        assert tc.driver.stats.as_dict() == pytest.approx(
            jc.driver.stats.as_dict(), rel=1e-12)
    finally:
        jc.driver._state = st0      # later tests start from deployment


def _key_choosing(cols):
    """A key whose ``jax.random.choice(key, K, (len(cols),), replace=False)``
    draws ``cols`` (searched over small seeds)."""
    for seed in range(10000):
        key = jax.random.PRNGKey(seed)
        if list(np.asarray(jax.random.choice(key, K, (len(cols),),
                                             replace=False))) == list(cols):
            return key
    raise AssertionError("no key draws the requested columns")


def test_health_hysteresis_and_budgets_match_reference():
    rng = np.random.default_rng(0)
    cfg_j = jmon.MonitorConfig(n_probes=6, alarm_threshold=0.05,
                               clear_threshold=0.02, consecutive=2)
    cfg_t = convert.monitor_config(cfg_j)
    hj, ht = jmon.HealthState(), tmon.HealthState()
    for i in range(200):
        est = float(rng.choice([0.01, 0.03, 0.049, 0.05, 0.051, 0.2,
                                rng.uniform(0, 0.1)]))
        dt = int(rng.integers(0, 6))
        if i % 17 == 16:
            hj, ht = (jmon.clear_health(hj, est, cfg_j),
                      tmon.clear_health(ht, est, cfg_t))
        else:
            hj, ht = (jmon.update_health(hj, est, cfg_j, dt=dt),
                      tmon.update_health(ht, est, cfg_t, dt=dt))
        assert dataclasses.asdict(ht) == dataclasses.asdict(hj)
    rc_j = JRecalConfig(zo_steps=400, auto_budget=True, auto_target=0.02)
    rc_t = convert.recal_config(rc_j)
    for dist in [0.0, 0.01, 0.02, 0.021, 0.05, 0.1, 0.3, 1.0, 10.0, 1e4]:
        for n_rot in (6, 15, 36):
            assert autotune_zo_steps(dist, rc_t, n_rot) == \
                j_autotune(dist, rc_j, n_rot)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _synthetic(mod, rng, n_chips=4, n_tenants=3):
    """The same randomized chip states (status, health, clocks, counters)
    built as the reference's or the port's types; no driver needed."""
    chips = []
    for c in range(n_chips):
        tenants = []
        for j in range(n_tenants):
            h = mod.HealthState(distance=float(rng.uniform(0, 0.1)),
                                strikes=int(rng.integers(0, 2)),
                                alarmed=bool(rng.random() < 0.3),
                                probes=int(rng.integers(0, 5)),
                                rate=float(rng.uniform(-1e-3, 3e-3)))
            tenants.append(dict(tenant_id=j, m=DIM, n=DIM,
                                block_range=(9 * j, 9 * j + 9),
                                w_blocks=None, health=h,
                                last_probe_tick=int(rng.integers(0, 50)),
                                served=int(rng.integers(0, 4))))
        chips.append(dict(chip_id=c, driver=None, tenants=tenants,
                          status=str(rng.choice([jfleet.HEALTHY,
                                                 jfleet.DEGRADED,
                                                 jfleet.RECALIBRATING])),
                          offline_ticks_left=int(rng.random() < 0.2),
                          served=int(rng.integers(0, 6))))
    return chips


def _build(mod, fl, chips):
    out = []
    for c in chips:
        c = dict(c)
        c["tenants"] = [fl.Tenant(**{**t, "health": dataclasses.replace(
            t["health"])}) for t in c["tenants"]]
        out.append(fl.Chip(**c))
    return out


@pytest.mark.parametrize("policy", ["drift_aware", "accuracy_aware",
                                    "least_served"])
def test_dispatch_and_route_pass_choices_match_reference(policy):
    cfg_j = _ref_cfg(router_policy=policy)
    cfg_t = convert.runtime_config(cfg_j)
    rng = np.random.default_rng({"drift_aware": 0, "accuracy_aware": 1,
                                 "least_served": 2}[policy])
    for trial in range(40):
        spec_j = _synthetic(jmon, rng)
        spec_t = [dict(c, tenants=[dict(t, health=tmon.HealthState(
            **dataclasses.asdict(t["health"]))) for t in c["tenants"]])
            for c in spec_j]
        rj = jfleet.FleetRouter(_build(jmon, jfleet, spec_j), cfg_j)
        rt = tfleet.FleetRouter(_build(tmon, tfleet, spec_t), cfg_t)
        now = int(rng.integers(0, 80))
        for r in (rj, rt):
            r.tick_count = now
            if trial % 2:
                r.set_sensitivity([0.5, 1.0, 2.0])
            for c in r.chips:     # drift past the floors taken at build
                for t in c.tenants:
                    t.health.distance *= 1.5
        for tenant in range(3):
            cj, ct = rj.dispatch(tenant), rt.dispatch(tenant)
            assert (None if cj is None else cj.chip_id) == \
                (None if ct is None else ct.chip_id)
            assert ct is None or ct.routable
        pj, pt = rj.route_pass(), rt.route_pass()
        assert (None if pj is None else pj.chip_id) == \
            (None if pt is None else pt.chip_id)
        for c_j, c_t in zip(rj.chips, rt.chips):
            for t_j, t_t in zip(c_j.tenants, c_t.tenants):
                assert tfleet.predicted_distance(
                    c_t, rt.tick_count, cfg_t.drift, t_t) == \
                    jfleet.predicted_distance(c_j, rj.tick_count,
                                              cfg_j.drift, t_j)


_STATUSES = [tfleet.HEALTHY, tfleet.DEGRADED, tfleet.RECALIBRATING]


@settings(max_examples=12, deadline=None)
@given(statuses=st.lists(st.sampled_from(_STATUSES), min_size=3,
                         max_size=3),
       offline=st.lists(st.booleans(), min_size=3, max_size=3),
       now=st.integers(0, 100), tenant=st.integers(0, 2),
       policy=st.sampled_from(["drift_aware", "accuracy_aware",
                               "least_served"]))
def test_router_never_dispatches_to_an_unroutable_chip(statuses, offline,
                                                       now, tenant, policy):
    rng = np.random.default_rng(now)
    spec = _synthetic(tmon, rng, n_chips=3)
    for c, s, off in zip(spec, statuses, offline):
        c["status"], c["offline_ticks_left"] = s, int(off)
    router = tfleet.FleetRouter(_build(tmon, tfleet, spec),
                                tfleet.RuntimeConfig(router_policy=policy))
    router.tick_count = now
    routable = [c.chip_id for c in router.chips if c.routable]
    for pick in (router.dispatch(tenant), router.route_pass()):
        assert (pick is None) == (not routable)
        assert pick is None or (pick.routable and pick.status != tfleet.
                                RECALIBRATING and not pick.offline)
    y, chip_id = router.serve(torch.zeros(DIM), tenant) if not routable \
        else (None, None)
    assert not routable or router.dropped == 0
    assert routable or (y is None and chip_id is None and router.dropped == 1)


# ---------------------------------------------------------------------------
# recalibration
# ---------------------------------------------------------------------------


def test_recalibrate_osp_and_sigma_descent_match_reference(ref_fleet):
    cfg, _, chips = ref_fleet
    jc = chips[1]
    h = jc.driver.unsafe_twin()
    st0 = h.drift_state
    for _ in range(30):
        jc.driver.advance(1.0)
    tc = _carry([jc], cfg)[0]
    ten_j, ten_t = jc.tenants[1], tc.tenants[1]
    rc_j = JRecalConfig(zo_steps=0, sl_steps=3, sl_probes=5, sl_lr=0.2)
    key = jax.random.PRNGKey(7)
    _, ks = jax.random.split(key)
    sl_x = np.stack([_f32(jax.random.normal(kk, (5, K)))
                     for kk in jax.random.split(ks, 3)])
    phi_j, sig_j = jc.driver.read_phases(), jc.driver.read_sigma()
    try:
        rj = j_recalibrate(key, jc.driver, ten_j.w_blocks, rc_j,
                           block_range=ten_j.block_range)
        rt = recalibrate(torch.Generator(), tc.driver, ten_t.w_blocks,
                         convert.recal_config(rc_j),
                         block_range=ten_t.block_range,
                         sl_x=torch.from_numpy(sl_x))
        for a, b in ((rt.sigma, rj.sigma), (rt.phi, rj.phi)):
            np.testing.assert_allclose(a.numpy(), _f32(b), atol=1e-5)
        for a, b in ((rt.dist_before, rj.dist_before),
                     (rt.dist_after_zo, rj.dist_after_zo),
                     (rt.dist_after, rj.dist_after)):
            assert _rel(float(a), float(b)) < 1e-5
        assert rt.zo_steps == rj.zo_steps == 0
        assert rt.ptc_calls == rj.ptc_calls > 0
        assert float(rt.dist_after) < float(rt.dist_after_zo)
        # co-tenants' commanded Σ untouched, the tenant's written
        sig_t = tc.driver.read_sigma()
        lo, hi = ten_t.block_range
        np.testing.assert_array_equal(sig_t[:lo].numpy(), _f32(sig_j)[:lo])
        np.testing.assert_array_equal(sig_t[hi:].numpy(), _f32(sig_j)[hi:])
        assert torch.equal(sig_t[lo:hi], rt.sigma)
    finally:
        jc.driver._state = st0
        jc.driver.write_phases(*phi_j)
        jc.driver.write_sigma(sig_j)


@settings(max_examples=4, deadline=None)
@given(victim=st.integers(0, 2), seed=st.integers(0, 3))
def test_partial_recal_leaves_cotenants_bit_identical(victim, seed):
    cfg = tdemo.default_runtime_config(k=3, sigma_drift=0.04, zo_steps=16)
    gen = torch.Generator().manual_seed(seed)
    ws = tdemo._make_weights(gen, 6, 3)
    chip = tfleet.make_chip(gen, 0, ws, cfg, device="cpu")
    for _ in range(20):
        chip.driver.advance(1.0)
    phi0 = torch.cat(chip.driver.read_phases(), dim=-1).clone()
    sig0 = chip.driver.read_sigma().clone()
    h = chip.driver.unsafe_twin()
    pre = [h.true_mapping_distance(t.w_blocks, t.block_range)
           for t in chip.tenants]
    ten = chip.tenants[victim]
    recalibrate(gen, chip.driver, ten.w_blocks, cfg.recal,
                block_range=ten.block_range)
    phi1 = torch.cat(chip.driver.read_phases(), dim=-1)
    sig1 = chip.driver.read_sigma()
    lo, hi = ten.block_range
    for a, b in ((phi0, phi1), (sig0, sig1)):
        assert torch.equal(a[:lo], b[:lo]) and torch.equal(a[hi:], b[hi:])
    post = [h.true_mapping_distance(t.w_blocks, t.block_range)
            for t in chip.tenants]
    assert all(pre[j] == post[j] for j in range(3) if j != victim)


# ---------------------------------------------------------------------------
# the lockstep fleet
# ---------------------------------------------------------------------------


def test_lockstep_fleet_matches_reference_to_first_recal_done(ref_fleet):
    cfg, ws, chips = ref_fleet
    cfg_t = convert.runtime_config(cfg)

    class RecordingRouter(jfleet.FleetRouter):
        """The reference router, keeping each health check's columns."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.columns = {c.chip_id: [] for c in self.chips}

        def _score_probe(self, chip, x, y_hat):
            self.columns[chip.chip_id].append(_f32(x))
            super()._score_probe(chip, x, y_hat)

    class InjectedRouter(tfleet.FleetRouter):
        """The port router, drawing the reference's columns."""

        source = None

        def _draw_probe(self, chip):
            queue = self.source.columns[chip.chip_id]
            if queue:
                return torch.from_numpy(queue.pop(0))
            return super()._draw_probe(chip)

    t_chips = _carry(chips, cfg)
    rj = RecordingRouter(chips, cfg, seed=1)
    rt = InjectedRouter(t_chips, cfg_t, seed=1)
    rt.source = rj
    w_t = convert.weights(ws)
    rng = np.random.default_rng(5)
    done_at = None
    for tick in range(1, 60):
        tenant = (tick - 1) % TENANTS
        x = rng.standard_normal((8, DIM)).astype(np.float32)
        yj, cj = rj.serve(jax.numpy.asarray(x), tenant=tenant)
        yt, ct = rt.serve(torch.from_numpy(x), tenant=tenant)
        assert cj == ct
        assert _rel(yt.numpy(), _f32(yj)) < 1e-5
        err_j = float(np.sum((_f32(yj) - x @ _f32(ws[tenant]).T) ** 2))
        err_t = float(torch.sum((yt - torch.from_numpy(x) @ w_t[tenant].T)
                                ** 2))
        assert _rel(err_t, err_j) < 1e-5
        rj.tick()
        for c_j, c_t in zip(rj.chips, rt.chips):
            c_t.driver._state = c_t.driver._state._replace(
                dev=convert.device_realization(c_j.driver.unsafe_twin().dev))
        rt.tick()
        first = next((i for i, ev in enumerate(rj.events)
                      if ev["event"] == "recal_done"), None)
        n = len(rj.events) if first is None else first
        assert len(rt.events) >= n
        for ev_j, ev_t in zip(rj.events[:n], rt.events[:n]):
            assert {k: v for k, v in ev_t.items() if k != "distance"} == \
                {k: v for k, v in ev_j.items() if k != "distance"}
            if "distance" in ev_j:
                assert _rel(ev_t["distance"], ev_j["distance"]) < 1e-5
        if first is not None:
            done_at = tick
            assert rt.events[first]["event"] == "recal_done"
            break
        for dj, dt in zip(rj.true_tenant_distances(),
                          rt.true_tenant_distances()):
            assert _rel(dt, dj) < 1e-5
        assert [c.status for c in rj.chips] == [c.status for c in rt.chips]
    assert done_at is not None, "the reference fleet never finished a recal"
    kinds = [ev["event"] for ev in rt.events]
    assert "alarm" in kinds and "recal_start" in kinds
    rep = rt.report()
    assert rep["dropped"] == 0 and rep["ticks"] == done_at


# ---------------------------------------------------------------------------
# simulate, main, the benchmarks
# ---------------------------------------------------------------------------


def test_simulate_serves_every_batch_and_reports():
    cfg = tdemo.default_runtime_config(k=K, sigma_drift=0.04, probe_every=5,
                                       zo_steps=64)
    out = tdemo.simulate(2, 24, dim=DIM, cfg=cfg, tenants=2, device="cpu")
    tr, rep = out["trace"], out["report"]
    assert tr["t"] == list(range(1, 25)) and rep["ticks"] == 24
    assert all(c >= 0 for c in tr["served_chip"]) and rep["dropped"] == 0
    assert tr["served_tenant"] == [t % 2 for t in range(24)]
    assert all(len(d) == 2 and len(d[0]) == 2 for d in tr["tenant_dist"])
    assert max(tr["max_dist"]) > cfg.monitor.alarm_threshold
    for ev in rep["events"]:
        if ev["event"] == "recal_done":
            assert ev["dist_after"] < cfg.monitor.clear_threshold
    assert sum(c["served"] for c in rep["chips"]) == 24
    assert out["config"]["device"] == "cpu"


@pytest.mark.parametrize("tenants", [1, 3])
def test_main_fast_smoke_meets_the_reference_exit_criteria(tenants, capsys):
    rc = tdemo.main(SMOKE + ["--tenants", str(tenants)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "40/40 batches served, 0 dropped" in out
    if tenants > 1:
        assert "within drift band" in out


def test_main_over_the_stream_transports(capsys):
    """``--driver subprocess|socket`` puts every chip behind a server
    child: the demo meets the exit criteria and prints the twin's
    timeline and summary line for line (the driver's name aside)."""
    outs = {}
    for transport in ("twin", "subprocess", "socket"):
        assert tdemo.main(SMOKE + ["--driver", transport]) == 0
        outs[transport] = capsys.readouterr().out.replace(
            f"({transport} driver", "(<driver>")
    assert "40/40 batches served, 0 dropped" in outs["twin"]
    assert outs["subprocess"] == outs["twin"] == outs["socket"]


def test_frozen_partial_recal_and_runner_registration():
    got = drift_recovery._frozen_partial_recal(device="cpu")
    assert got["recovered"] and got["cotenants_bit_identical"]
    assert got["ptc_calls"] > 0
    names = [name for name, _ in bench_run.BENCHES]
    assert names[-6:] == ["runtime_drift_recovery", "runtime_multi_tenant",
                          "hw_driver_overhead", "runtime_e2e_accuracy",
                          "serving_gateway", "fleet_autopilot"]
    assert [name for name, _ in bench_run.TABLES] == names[:6]
    # the multi-tenant benchmark's subprocess leg: the frozen-device check
    # over a server child gives the twin's distances bit for bit
    sub = drift_recovery._frozen_partial_recal("subprocess", device="cpu")
    assert (sub["recal_tenant"], sub["dist_pre"], sub["dist_post"],
            sub["ptc_calls"]) == (got["recal_tenant"], got["dist_pre"],
                                  got["dist_post"], got["ptc_calls"])
