"""Fleet-autopilot benchmark: forecast-driven against alarm-driven upkeep.

Counterpart of ``benchmarks/fleet_autopilot.py``.  One seeded **diurnal**
workload (bursty Poisson arrivals over a sinusoidal day, correlated drift
bursts, injected chip outages) drives both schedulers on fleets drawn from
one seed:

1. **Scheduler duel** — the reactive loop (``drift_aware`` routing, FIFO
   repair) against the autopilot (``accuracy_aware`` routing,
   degradation-rate priority, trough-scheduled proactive recals under a
   PTC-call envelope).  A queue model turns routable capacity into
   per-request latency; every served request's relative error is measured
   through the chip's drifted transfer.  Gates: the autopilot's accuracy
   no worse, strictly fewer reactive alarms, every budget window's
   proactive spend within the envelope (plus one repair window's work in
   flight).
2. **Sensitivity calibration** — the ``logit_sensitivity`` prior ranks
   tenants as their measured output-error energy on drifted hardware does.
3. **Gateway leg** — one continuous-batching run with ``--hw-logits`` and
   ``--autopilot`` (smoke:qwen3-4b, 3 slots, 8 requests, 2 chips of
   k = 8, σ_drift 0.008): the occupancy signal reaches the router's load
   forecast and every request completes.

The weights, the day's schedule, the served rows and the requests are the
reference's numpy draws; the fleets and the routers draw from CPU
generators seeded like the reference's keys.  Writes
``bench_artifacts/torch/fleet_autopilot.csv`` and
``BENCH_fleet_autopilot.json`` and raises if a gate fails.

    PYTHONPATH=src python -m repro_torch.benchmarks.fleet_autopilot \\
        [--budget quick|normal] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ..device import resolve_device
from .common import ART, emit

__all__ = ["main", "run_arm", "sensitivity_validation", "gateway_leg",
           "tenant_weights"]

SEED = 11
CHIPS = 3
TENANTS = 2
DIM = 12
K = 4
SIGMA = 0.02
PROBE_EVERY = 5
PERIOD = 80                      # ticks per diurnal cycle
RATE_BASE = 2.0                  # mean arrivals/tick at mid-day
RATE_AMP = 0.9                   # peak/trough swing
CAP_PER_CHIP = 2                 # requests a routable chip absorbs/tick
LAT_SLO = 6.0                    # ticks: queue-latency SLO
ERR_SLO = 0.08                   # realized relative serve error SLO
BUDGET_CALLS = 60_000.0          # proactive recal PTC-call envelope/window
HORIZON = 30
TROUGH = 0.55


def _runtime_cfg(autopilot=None, policy="drift_aware"):
    from ..runtime.demo import default_runtime_config

    # auto_budget: repair jobs sized to the measured drift depth, so the
    # shallow proactive repairs cost a fraction of a full-depth job
    cfg = default_runtime_config(k=K, sigma_drift=SIGMA,
                                 probe_every=PROBE_EVERY, auto_budget=True)
    return dataclasses.replace(cfg, router_policy=policy,
                               autopilot=autopilot, max_concurrent_recals=2)


def _make_ap_cfg():
    from ..runtime.autopilot import AutopilotConfig
    return AutopilotConfig(horizon=HORIZON, trough_load=TROUGH,
                           budget_calls=BUDGET_CALLS, budget_window=PERIOD,
                           forecast_period=PERIOD, forecast_alpha=0.3)


def tenant_weights() -> list[np.ndarray]:
    """Two mapped layers with distinct Frobenius energies (the
    reference's numpy draws), so the sensitivity prior has a ranking."""
    rng = np.random.default_rng(SEED)
    scales = [1.0, 1.7][:TENANTS]
    return [np.asarray(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)
                       * s, np.float32) for s in scales]


def _schedule(ticks: int):
    """The seeded day: per-tick arrivals, correlated drift bursts and chip
    outages, replayed identically in both arms."""
    rng = np.random.default_rng(SEED + 1)
    lam = RATE_BASE * (1.0 + RATE_AMP
                       * np.sin(2.0 * np.pi * np.arange(ticks) / PERIOD))
    arrivals = rng.poisson(np.maximum(lam, 0.05))
    tenant_of = rng.integers(0, TENANTS, size=int(arrivals.sum()))
    # a thermal event ages one chip by several extra ticks at once
    bursts = {}
    for t in rng.choice(np.arange(10, ticks - 10), size=max(2, ticks // 60),
                        replace=False):
        bursts[int(t)] = (int(rng.integers(0, CHIPS)), 12.0)
    # one outage a day, on the mid-morning ramp
    outages = {int(PERIOD * (i + 0.3)): (i % CHIPS, 8)
               for i in range(max(1, ticks // PERIOD - 1))}
    return arrivals, tenant_of, bursts, outages


def run_arm(label: str, ticks: int, autopilot=None,
            policy: str = "drift_aware", device=None) -> dict:
    """One scheduler arm over the seeded day on ``device``: summary stats
    and the per-window recal spend."""
    from ..runtime.autopilot import logit_sensitivity
    from ..runtime.fleet import make_fleet, make_router

    dev = resolve_device(device)
    weights = tenant_weights()
    w_dev = [torch.from_numpy(w).to(dev) for w in weights]
    cfg = _runtime_cfg(autopilot=autopilot, policy=policy)
    chips = make_fleet(torch.Generator("cpu").manual_seed(SEED + 2), CHIPS,
                       w_dev, cfg, device=dev)
    router = make_router(chips, cfg, seed=SEED + 3)
    if policy == "accuracy_aware":
        router.set_sensitivity(logit_sensitivity(weights))

    arrivals, tenant_of, bursts, outages = _schedule(ticks)
    xs = [np.asarray(np.random.default_rng(SEED + 4 + j)
                     .standard_normal((4, DIM)), np.float32)
          for j in range(TENANTS)]
    x_dev = [torch.from_numpy(x).to(dev) for x in xs]
    y_ref = [x @ w.T for x, w in zip(x_dev, w_dev)]
    ref_energy = [torch.sum(y ** 2) for y in y_ref]

    queue: list[tuple[int, int]] = []     # (arrival_tick, tenant)
    next_req = 0
    lat, err = [], []
    cap_full = CAP_PER_CHIP * CHIPS
    spend_series, series = [], []
    for t in range(ticks):
        for _ in range(int(arrivals[t])):
            queue.append((t, int(tenant_of[next_req])))
            next_req += 1
        load = min(1.0, len(queue) / cap_full)
        router.observe_load(load)
        router.tick()
        if t in bursts:
            c, extra = bursts[t]
            chips[c].driver.advance(extra)
        if t in outages:
            c, dur = outages[t]
            router.inject_outage(c, dur)
        cap = CAP_PER_CHIP * sum(c.routable for c in chips)
        for _ in range(min(cap, len(queue))):
            t0, ten = queue.pop(0)
            y, _cid = router.serve(x_dev[ten], tenant=ten)
            lat.append(t - t0)
            err.append(torch.sum((y - y_ref[ten]) ** 2) / ref_energy[ten])
        spend_series.append(sum(c.recal_calls for c in chips))
        series.append(dict(tick=t, load=load, queue=len(queue)))

    rep = router.report()
    alarms = sum(c["alarms"] for c in rep["chips"])
    recals = sum(c["recals"] for c in rep["chips"])
    lat_a = np.asarray(lat, float)
    err_a = torch.stack(err).double().cpu().numpy()   # one host sync
    slo = float(np.mean((lat_a <= LAT_SLO) & (err_a <= ERR_SLO)))
    # per-window recal spend from the public counters
    window = (autopilot.budget_window if autopilot is not None else PERIOD)
    marks = [0.0] + [spend_series[min(i + window, ticks) - 1]
                     for i in range(0, ticks, window)]
    window_spend = [b - a for a, b in zip(marks, marks[1:])]
    deltas = [b - a for a, b in zip([0.0] + spend_series, spend_series)]
    out = dict(
        label=label, ticks=ticks, requests=len(lat),
        unserved=len(queue), dropped=rep["dropped"],
        alarms=alarms, recals=recals,
        p50_latency=float(np.percentile(lat_a, 50)),
        p99_latency=float(np.percentile(lat_a, 99)),
        mean_err=float(err_a.mean()), p99_err=float(np.percentile(err_a, 99)),
        max_err=float(err_a.max()), slo_attainment=slo,
        recal_ptc_calls=float(spend_series[-1]),
        window_spend=window_spend, max_job_cost=max(deltas, default=0.0),
        autopilot=rep.get("autopilot"), series=series)
    print(f"{label:>10s}: {len(lat)} served | latency p50 "
          f"{out['p50_latency']:.1f} p99 {out['p99_latency']:.1f} | err "
          f"mean {out['mean_err']:.4f} p99 {out['p99_err']:.4f} | "
          f"{alarms} alarms, {recals} recals | SLO {slo:.3f}", flush=True)
    router.close()
    return out


def sensitivity_validation(device=None) -> dict:
    """Tenants of distinct energies on ONE drifted chip: the predicted
    error leverage (sensitivity × realized relative distance) must rank
    them as their measured output-error energy does."""
    from ..runtime.autopilot import logit_sensitivity
    from ..runtime.fleet import make_chip

    dev = resolve_device(device)
    rng = np.random.default_rng(SEED + 9)
    weights = [np.asarray(rng.standard_normal((DIM, DIM)) / np.sqrt(DIM)
                          * s, np.float32) for s in (0.6, 1.0, 1.8)]
    chip = make_chip(torch.Generator("cpu").manual_seed(SEED + 10), 0,
                     [torch.from_numpy(w).to(dev) for w in weights],
                     _runtime_cfg(), device=dev)
    for _ in range(60):
        chip.driver.advance(1.0)
    sens = logit_sensitivity(weights)
    x = torch.from_numpy(np.asarray(rng.standard_normal((16, DIM)),
                                    np.float32)).to(dev)
    measured, predicted = [], []
    for t, w in zip(chip.tenants, weights):
        y = chip.driver.forward_layer(x, block_range=t.block_range,
                                      out_dim=t.m)
        y_ref = x @ torch.from_numpy(w).to(dev).T
        e = float(torch.sum((y - y_ref) ** 2)) / x.shape[0]
        d = float(torch.sum((y - y_ref) ** 2) / torch.sum(y_ref ** 2))
        measured.append(e)
        predicted.append(sens[t.tenant_id] * d)
    rank_ok = list(np.argsort(measured)) == list(np.argsort(predicted))
    print(f"sensitivity: prior {['%.2f' % s for s in sens]} | measured "
          f"err-energy {['%.4f' % e for e in measured]} | rank match "
          f"{rank_ok}", flush=True)
    return dict(sensitivity=sens, measured_err_energy=measured,
                predicted_leverage=predicted, rank_ok=bool(rank_ok))


def gateway_leg(device=None) -> dict:
    """One continuous-batching run with the autopilot on: the occupancy
    signal must reach the load forecast and every request complete."""
    from ..configs import parse_arch
    from ..models.lm import init_model
    from ..serving.gateway import run as gw_run
    from ..serving.scheduler import poisson_workload

    dev = resolve_device(device)
    arch = "smoke:qwen3-4b"
    cfg = parse_arch(arch)
    params = init_model(torch.Generator(dev).manual_seed(0), cfg)
    reqs = poisson_workload(SEED + 5, 8, 2.0, cfg.vocab,
                            prompt_len=(4, 8), max_new=(8, 12))
    args = argparse.Namespace(
        arch=arch, seed=SEED, slots=3, requests=len(reqs), rate=1.0,
        max_new=(8, 12), eos_id=None, page_size=8, pages=32,
        max_pages_per_slot=4, prefill_chunk=1,
        fleet=2, drift=True, drift_sigma=0.008, probe_every=10,
        fleet_k=8, fleet_driver="twin", hw_logits=True, hw_shadow=False,
        deploy_zo=False, no_recal=False, params_override=params,
        requests_override=[dataclasses.replace(r, out_tokens=[])
                           for r in reqs],
        autopilot=True, ap_horizon=HORIZON, ap_trough=TROUGH,
        ap_budget=None, ap_window=PERIOD, fleet_policy="accuracy_aware",
        device=dev)
    rep = gw_run(args)
    expected = sum(r.max_new for r in reqs)
    ap = rep["fleet"].get("autopilot") or {}
    hw = rep["fleet"]["hw"]
    complete = rep["tokens_out"] == expected
    print(f"gateway leg: {rep['tokens_out']}/{expected} tok | p99 latency "
          f"{rep['latency_steps']['p99']:.0f} steps | "
          f"{ap.get('proactive_recals', 0)} proactive recals | load "
          f"samples {ap.get('load_samples', 0)} | {hw['hw_calls']} hw "
          f"matmuls, {hw['shadow_calls']} shadow | complete={complete}",
          flush=True)
    return dict(tokens_out=rep["tokens_out"], expected_tokens=expected,
                complete=bool(complete),
                p99_latency_steps=rep["latency_steps"]["p99"],
                occupancy=rep["occupancy"], autopilot=ap,
                hw=dict(hw, layers=len(hw["layers"])),
                wall_s=rep["wall_s"])


def main(budget: str = "quick", device=None) -> dict:
    """The duel, the calibration and the gateway leg on ``device``; returns
    {table: rows} and raises if a gate fails."""
    ticks = 240 if budget == "quick" else 480
    base = run_arm("reactive", ticks, device=device)
    ap = run_arm("autopilot", ticks, autopilot=_make_ap_cfg(),
                 policy="accuracy_aware", device=device)
    sens = sensitivity_validation(device)
    gw = gateway_leg(device)

    # the envelope gates *admission*: a proactive job admitted while the
    # window's spend is under budget may land after it closed, so allow one
    # repair window's work in flight (the largest single landing × the 2
    # repair slots); reactive spend is exempt
    slack = ap["max_job_cost"] * 2
    ap_rep = ap["autopilot"] or {}
    proactive_windows = (list(ap_rep.get("proactive_windows", []))
                         + [ap_rep.get("window_spent", 0.0)])
    budget_ok = all(w <= BUDGET_CALLS + slack for w in proactive_windows)

    gates = dict(
        autopilot_accuracy_no_worse=bool(
            ap["mean_err"] <= base["mean_err"] * 1.05 + 1e-9),
        fewer_reactive_alarms=bool(ap["alarms"] < base["alarms"]),
        recal_budget_within_envelope=bool(budget_ok),
        sensitivity_rank_validated=bool(sens["rank_ok"]),
        gateway_autopilot_completes=bool(gw["complete"]))

    rows = [[a["label"], a["requests"], f"{a['p50_latency']:.1f}",
             f"{a['p99_latency']:.1f}", f"{a['mean_err']:.5f}",
             f"{a['p99_err']:.5f}", a["alarms"], a["recals"],
             f"{a['slo_attainment']:.4f}"] for a in (base, ap)]
    emit("fleet_autopilot",
         ["arm", "requests", "p50_latency", "p99_latency", "mean_err",
          "p99_err", "alarms", "recals", "slo_attainment"], rows)

    for a in (base, ap):
        a.pop("series")
    summary = dict(
        budget=budget, seed=SEED, ticks=ticks,
        device=str(resolve_device(device)),
        workload=dict(chips=CHIPS, tenants=TENANTS, dim=DIM, k=K,
                      sigma=SIGMA, period=PERIOD, rate_base=RATE_BASE,
                      rate_amp=RATE_AMP, cap_per_chip=CAP_PER_CHIP,
                      lat_slo=LAT_SLO, err_slo=ERR_SLO),
        autopilot_cfg=dict(horizon=HORIZON, trough_load=TROUGH,
                           budget_calls=BUDGET_CALLS, budget_window=PERIOD),
        reactive=base, autopilot=ap,
        alarms_averted_frac=(
            (base["alarms"] - ap["alarms"]) / max(1, base["alarms"])),
        budget_slack_used=slack, proactive_window_spend=proactive_windows,
        sensitivity=sens, gateway=gw, gates=gates)
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / "BENCH_fleet_autopilot.json"
    path.write_text(json.dumps(summary, indent=2))
    print(f"--- fleet_autopilot summary ({path}) ---")
    print(json.dumps(dict(gates=gates,
                          alarms=(base["alarms"], ap["alarms"]),
                          slo=(base["slo_attainment"],
                               ap["slo_attainment"])), indent=2), flush=True)
    for name, ok in gates.items():
        assert ok, f"fleet autopilot gate failed: {name}"
    return {"fleet_autopilot": rows, "summary": summary}


if __name__ == "__main__":
    _ap = argparse.ArgumentParser()
    _ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    _ap.add_argument("--device", default=None)
    _a = _ap.parse_args()
    main(_a.budget, device=_a.device)
