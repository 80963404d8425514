"""Port parity: ``repro_torch.runtime.autopilot`` against
``repro.runtime.autopilot``.

The pure forecasts (``predicted_crossing``, ``LoadForecast``,
``logit_sensitivity``) and the scheduler's choices (the priority queue and
``_schedule_repairs`` over the same randomized chip states and load
samples) must agree exactly; ``logit_sensitivity`` sums in float64 on both
sides, to 1e-12.  The end-to-end behaviours the reference tests (proactive
repairs before the crossing, the budget envelope, σ = 0 policy
equivalence, outages) run on the port's own fleet at k = 4, dim 8.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.hw.drift import DriftConfig as JDriftConfig
from repro.runtime import autopilot as jap
from repro.runtime import fleet as jfleet
from repro.runtime import monitor as jmon
from repro_torch import convert
from repro_torch.hw import DriftConfig
from repro_torch.runtime import fleet as tfleet
from repro_torch.runtime import monitor as tmon
from repro_torch.runtime.autopilot import (AutopilotConfig, AutopilotRouter,
                                           LoadForecast, logit_sensitivity,
                                           predicted_crossing)
from repro_torch.runtime.monitor import MonitorConfig
from repro_torch.runtime.recalibrate import RecalConfig

K, DIM = 4, 8
DRIFT = DriftConfig(sigma_phase=0.03, theta=0.01)


def test_predicted_crossing_matches_reference():
    rng = np.random.default_rng(0)
    cases = [(0.08, 0.01, 0.05), (0.05, 0.01, 0.05), (0.01, 0.0, 0.05),
             (0.01, -0.002, 0.05), (0.02, 0.0054, 0.05), (0.02, 0.5, 0.05)]
    cases += [tuple(rng.uniform(0, v) for v in (0.1, 0.02, 0.1))
              for _ in range(300)]
    for theta in (0.01, 0.05, 0.0):
        dj = JDriftConfig(sigma_phase=0.03, theta=theta)
        dt = convert.drift_config(dj)
        for d, r, thr in cases:
            assert predicted_crossing(d, r, thr, dt) == \
                jap.predicted_crossing(d, r, thr, dj)
    assert predicted_crossing(0.08, 0.01, 0.05, DRIFT) == 0.0
    assert predicted_crossing(0.01, 0.0, 0.05, DRIFT) == math.inf
    assert predicted_crossing(0.02, 0.5, 0.05, DRIFT) == \
        pytest.approx(0.03 / 0.5, rel=0.05)


@pytest.mark.parametrize("period", [0, 4, 24])
def test_load_forecast_matches_reference(period):
    rng = np.random.default_rng(period)
    ft, fj = LoadForecast(period, 0.2), jap.LoadForecast(period, 0.2)
    assert ft.forecast(0) == fj.forecast(0) == 1.0
    for tick in range(200):
        load = float(rng.uniform(0, 1.2))
        ft.observe(load, tick)
        fj.observe(load, tick)
        probe = int(rng.integers(0, 400))
        assert ft.forecast(probe) == fj.forecast(probe)
    assert ft.samples == fj.samples == 200


def test_logit_sensitivity_matches_reference():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((DIM, DIM)).astype(np.float32)
    ws = [0.5 * base, base, 2.0 * base,
          rng.standard_normal((3, 5)).astype(np.float32)]
    got = logit_sensitivity([torch.from_numpy(w) for w in ws])
    np.testing.assert_allclose(got, jap.logit_sensitivity(ws), rtol=1e-12)
    assert got[0] < got[1] < got[2]
    assert logit_sensitivity([np.zeros((2, 2))] * 3) == [1.0] * 3


def _synthetic_chips(mod, fl, rng, n_chips=3, n_tenants=2):
    chips = []
    for c in range(n_chips):
        tenants = [fl.Tenant(
            tenant_id=j, m=DIM, n=DIM, block_range=(4 * j, 4 * j + 4),
            w_blocks=None,
            health=mod.HealthState(distance=float(rng.uniform(0, 0.08)),
                                   strikes=int(rng.integers(0, 2)),
                                   alarmed=bool(rng.random() < 0.25),
                                   probes=int(rng.integers(1, 6)),
                                   rate=float(rng.uniform(-1e-3, 4e-3))),
            last_probe_tick=int(rng.integers(0, 40)))
            for j in range(n_tenants)]
        chips.append(fl.Chip(chip_id=c, driver=None, tenants=tenants,
                             status=str(rng.choice(
                                 [fl.HEALTHY, fl.HEALTHY, fl.DEGRADED,
                                  fl.RECALIBRATING])),
                             offline_ticks_left=int(rng.random() < 0.15)))
    return chips


def _copy_chips(chips):
    return [tfleet.Chip(
        chip_id=c.chip_id, driver=None, status=c.status,
        offline_ticks_left=c.offline_ticks_left,
        tenants=[tfleet.Tenant(
            tenant_id=t.tenant_id, m=t.m, n=t.n, block_range=t.block_range,
            w_blocks=None, last_probe_tick=t.last_probe_tick,
            health=tmon.HealthState(**dataclasses.asdict(t.health)))
            for t in c.tenants]) for c in chips]


@pytest.mark.parametrize("trough,budget", [(0.5, math.inf), (0.05, math.inf),
                                           (0.5, 0.0)])
def test_scheduler_choices_match_reference(trough, budget):
    ap_j = jap.AutopilotConfig(horizon=40, trough_load=trough,
                               budget_calls=budget, forecast_period=8)
    cfg_j = jfleet.RuntimeConfig(
        k=K, drift=JDriftConfig(sigma_phase=0.03, theta=0.01),
        monitor=jmon.MonitorConfig(alarm_threshold=0.05, clear_threshold=0.03),
        probe_every=5, recal_latency=2, max_concurrent_recals=2,
        autopilot=ap_j)
    cfg_t = convert.runtime_config(cfg_j)
    assert cfg_t.autopilot == AutopilotConfig(**dataclasses.asdict(ap_j))
    rng = np.random.default_rng(int(trough * 100) + int(budget == 0.0))
    for trial in range(30):
        chips_j = _synthetic_chips(jmon, jfleet, rng)
        rj = jap.AutopilotRouter(chips_j, cfg_j)
        rt = AutopilotRouter(_copy_chips(chips_j), cfg_t)
        now = int(rng.integers(20, 120))
        for r in (rj, rt):
            r.tick_count = now
        for tick in range(now - 10, now):
            load = float(rng.uniform(0, 1))
            for r in (rj, rt):
                r.forecast.observe(load, tick)
        for cj, ct in zip(rj.chips, rt.chips):
            for tj, tt in zip(cj.tenants, ct.tenants):
                assert rt.crossing(ct, tt) == rj.crossing(cj, tj)
        pend_j = [(c, 0, None, None) for c in rj.chips]
        pend_t = [(c, 0, None, None) for c in rt.chips]
        qj = [(key, c.chip_id, t.tenant_id)
              for key, c, t in rj._repair_queue(pend_j)]
        qt = [(key, c.chip_id, t.tenant_id)
              for key, c, t in rt._repair_queue(pend_t)]
        assert qt == qj
        rj._schedule_repairs(pend_j)
        rt._schedule_repairs(pend_t)
        assert rt.events == rj.events
        assert [c.status for c in rt.chips] == [c.status for c in rj.chips]
        assert (rt.proactive_recals, rt.deferred_trough,
                rt.deferred_budget) == (rj.proactive_recals,
                                        rj.deferred_trough,
                                        rj.deferred_budget)


# ---------------------------------------------------------------------------
# the port's own fleet
# ---------------------------------------------------------------------------


def _cfg(**kw):
    defaults = dict(
        k=K, drift=DRIFT,
        monitor=MonitorConfig(n_probes=8, alarm_threshold=0.05,
                              clear_threshold=0.03, consecutive=2),
        recal=RecalConfig(zo_steps=120, delta0=0.05),
        probe_every=5, recal_latency=2, max_concurrent_recals=1)
    defaults.update(kw)
    return tfleet.RuntimeConfig(**defaults)


def _weights(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((DIM, DIM))
                              / np.sqrt(DIM)).astype(np.float32))
            for _ in range(n)]


def _autopilot_router(ap, seed=3, n_chips=2, **cfg_kw):
    cfg = _cfg(autopilot=ap, **cfg_kw)
    chips = tfleet.make_fleet(torch.Generator().manual_seed(0), n_chips,
                              _weights(), cfg, device="cpu")
    router = tfleet.make_router(chips, cfg, seed=seed)
    assert isinstance(router, AutopilotRouter)
    return router, chips


def _drive(router, ticks, load=0.0):
    for _ in range(ticks):
        router.observe_load(load)
        router.tick()


def test_proactive_repairs_come_before_the_crossing_and_budget_gates_them():
    drift = DriftConfig(sigma_phase=0.02, theta=0.01)
    router, _ = _autopilot_router(AutopilotConfig(horizon=40, trough_load=0.5),
                                  drift=drift)
    _drive(router, 120)
    rep = router.report()
    assert router.proactive_recals > 0
    assert sum(c["alarms"] for c in rep["chips"]) == 0
    starts = [e for e in router.events if e["event"] == "recal_start"]
    assert starts and all(e.get("proactive") for e in starts)
    assert router.proactive_calls == pytest.approx(
        sum(c["recal_ptc_calls"] for c in rep["chips"]), rel=1e-9)
    assert rep["autopilot"]["proactive_recals"] == router.proactive_recals

    router, _ = _autopilot_router(
        AutopilotConfig(horizon=40, trough_load=0.5, budget_calls=0.0),
        drift=drift)
    _drive(router, 120)
    assert router.proactive_recals == 0 and router.deferred_budget > 0
    rep = router.report()
    if sum(c["alarms"] for c in rep["chips"]):
        assert sum(c["recals"] for c in rep["chips"]) > 0


def test_accuracy_aware_matches_drift_aware_at_sigma_zero():
    routers = []
    for policy in ("drift_aware", "accuracy_aware"):
        cfg = _cfg(drift=DriftConfig(sigma_phase=0.0, theta=0.01),
                   router_policy=policy, probe_every=10 ** 6)
        chips = tfleet.make_fleet(torch.Generator().manual_seed(0), 3,
                                  _weights(), cfg, device="cpu")
        routers.append(tfleet.make_router(chips, cfg, seed=5))
    xs = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (20, 4, DIM)).astype(np.float32))
    for i, x in enumerate(xs):
        picked = []
        for router in routers:
            router.tick()
            picked.append(router.serve(x, tenant=i % 2)[1])
        assert picked[0] == picked[1]


def test_outage_makes_chip_unroutable_until_it_lifts():
    router, chips = _autopilot_router(AutopilotConfig())
    router.inject_outage(chips[0].chip_id, 3)
    assert chips[0].offline and not chips[0].routable
    for _ in range(3):
        _, chip_id = router.serve(torch.zeros((2, DIM)), tenant=0)
        assert chip_id == chips[1].chip_id
        router.tick()
    assert not chips[0].offline
    kinds = [e["event"] for e in router.events]
    assert kinds[0] == "outage" and "outage_end" in kinds
