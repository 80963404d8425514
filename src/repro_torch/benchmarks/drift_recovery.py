"""Closed-loop drift recovery: fidelity vs. time, with and without the loop.

Counterpart of ``benchmarks/drift_recovery.py``.  :func:`main` runs the
fleet simulation (``repro_torch.runtime.demo.simulate``) twice from one
seed, closed loop (monitor → alarm → recalibrate) and open loop, and
writes under ``bench_artifacts/torch/``:

* ``drift_recovery.csv``: per-tick recovery curves of both loops;
* ``BENCH_drift_recovery.json``: time to recovery per alarm, peak and
  final distances, serving continuity, probe / recal overhead in PTC
  calls.

:func:`multi_tenant` is the multi-tenant scenario (chips time-multiplexed
across three mapped layers, partial recalibration): every alarmed tenant
recovers below the alarm threshold while co-tenants' true distances move
no more than their natural drift, and a partial recal on a frozen device
leaves co-tenants exactly unchanged (``BENCH_multi_tenant.json``), on the
in-process twin and over the subprocess transport (a device server child
per chip), each under ``transports[...]``.

    PYTHONPATH=src python -m repro_torch.benchmarks.drift_recovery \\
        [--budget quick|normal] [--scenario single|multi_tenant] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..runtime.demo import (simulate, default_runtime_config, _make_weights,
                            cotenant_shifts, drift_noise_band,
                            isolation_band)
from ..runtime.fleet import make_chip
from ..runtime.recalibrate import recalibrate
from .common import ART, emit, Timer

__all__ = ["main", "multi_tenant"]

def _time_to_recovery(events: list[dict], clear_threshold: float) -> list[dict]:
    """Pair each alarm with the first later recal_done on the same (chip,
    tenant) slot whose post-recal distance clears ``clear_threshold``."""
    open_alarms: dict[tuple, int] = {}
    out = []
    for ev in events:
        slot = (ev["chip"], ev.get("tenant", 0))
        if ev["event"] == "alarm":
            open_alarms.setdefault(slot, ev["tick"])
        elif (ev["event"] == "recal_done" and slot in open_alarms
              and ev["dist_after"] < clear_threshold):
            alarm_tick = open_alarms.pop(slot)
            out.append(dict(chip=slot[0], tenant=slot[1],
                            alarm_tick=alarm_tick,
                            recover_tick=ev["tick"],
                            ticks=ev["tick"] - alarm_tick,
                            dist_after=ev["dist_after"]))
    return out


def _write_json(name: str, summary: dict) -> None:
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / name
    path.write_text(json.dumps(summary, indent=2))
    print(f"--- {name} ({path}) ---")
    print(json.dumps(summary, indent=2), flush=True)


def main(budget: str = "quick", device=None) -> dict:
    """Closed against open loop on ``device``; returns {table: rows}."""
    chips, steps = (3, 120) if budget == "quick" else (4, 300)
    cfg = default_runtime_config()

    results = {}
    for mode, enabled in (("closed", True), ("open", False)):
        with Timer(device) as t:
            results[mode] = simulate(chips, steps, seed=0, cfg=cfg,
                                     recal_enabled=enabled, device=device)
        results[mode]["wall_s"] = t.dt

    closed, open_ = results["closed"], results["open"]
    tr_c, tr_o = closed["trace"], open_["trace"]
    header = ["t", "closed_max_dist", "closed_mean_dist", "closed_serve_err",
              "closed_in_repair", "open_max_dist", "open_mean_dist",
              "open_serve_err"]
    rows = []
    for i, t in enumerate(tr_c["t"]):
        rows.append([t,
                     f"{tr_c['max_dist'][i]:.5f}",
                     f"{tr_c['mean_dist'][i]:.5f}",
                     f"{tr_c['serve_err'][i]:.5f}",
                     tr_c["n_recalibrating"][i],
                     f"{tr_o['max_dist'][i]:.5f}",
                     f"{tr_o['mean_dist'][i]:.5f}",
                     f"{tr_o['serve_err'][i]:.5f}"])
    emit("drift_recovery", header, rows)

    rep_c = closed["report"]
    recoveries = _time_to_recovery(rep_c["events"],
                                   cfg.monitor.clear_threshold)
    probe_calls = sum(c["probe_ptc_calls"] for c in rep_c["chips"])
    recal_calls = sum(c["recal_ptc_calls"] for c in rep_c["chips"])
    serve_calls = sum(c["serve_ptc_calls"] for c in rep_c["chips"])
    _write_json("BENCH_drift_recovery.json", dict(
        budget=budget, chips=chips, steps=steps,
        device=closed["config"]["device"],
        alarm_threshold=cfg.monitor.alarm_threshold,
        clear_threshold=cfg.monitor.clear_threshold,
        sigma_drift=cfg.drift.sigma_phase,
        closed=dict(
            peak_max_dist=max(tr_c["max_dist"]),
            final_max_dist=tr_c["max_dist"][-1],
            mean_serve_err=sum(tr_c["serve_err"]) / len(tr_c["serve_err"]),
            dropped=rep_c["dropped"],
            alarms=sum(c["alarms"] for c in rep_c["chips"]),
            recals=sum(c["recals"] for c in rep_c["chips"]),
            wall_s=closed["wall_s"]),
        open=dict(
            peak_max_dist=max(tr_o["max_dist"]),
            final_max_dist=tr_o["max_dist"][-1],
            mean_serve_err=sum(tr_o["serve_err"]) / len(tr_o["serve_err"]),
            dropped=open_["report"]["dropped"],
            wall_s=open_["wall_s"]),
        time_to_recovery_ticks=[r["ticks"] for r in recoveries],
        mean_time_to_recovery=(sum(r["ticks"] for r in recoveries)
                               / len(recoveries)) if recoveries else None,
        probe_overhead_ptc_calls=probe_calls,
        recal_overhead_ptc_calls=recal_calls,
        serve_ptc_calls=serve_calls,
        probe_overhead_frac=probe_calls / serve_calls))
    return {"drift_recovery": rows}


def _frozen_partial_recal(driver_kind: str = "twin", seed: int = 0,
                          device=None) -> dict:
    """With the device frozen during the job: drift a 3-tenant chip until
    its worst tenant is past the alarm threshold, partially recalibrate
    that tenant, and read every tenant's true distance before and after;
    co-tenants must be exactly unchanged."""
    cfg = default_runtime_config(k=4, sigma_drift=0.04,
                                 driver_kind=driver_kind)
    dim, tenants = 12, 3
    gen = torch.Generator("cpu").manual_seed(seed)
    ws = _make_weights(gen, dim, tenants)
    chip = make_chip(gen, 0, ws, cfg, device=device)
    try:
        for _ in range(60):
            chip.driver.advance(1.0)
        h = chip.driver.unsafe_twin()
        pre = [h.true_mapping_distance(t.w_blocks, t.block_range)
               for t in chip.tenants]
        worst = max(range(tenants), key=lambda j: pre[j])
        ten = chip.tenants[worst]
        res = recalibrate(gen, chip.driver, ten.w_blocks, cfg.recal,
                          block_range=ten.block_range)
        post = [h.true_mapping_distance(t.w_blocks, t.block_range)
                for t in chip.tenants]
    finally:
        chip.driver.close()
    return dict(
        driver=driver_kind, recal_tenant=worst,
        dist_pre=pre, dist_post=post,
        recovered=bool(post[worst] < cfg.monitor.alarm_threshold),
        cotenants_bit_identical=all(
            pre[j] == post[j] for j in range(tenants) if j != worst),
        ptc_calls=res.ptc_calls)


def multi_tenant(budget: str = "quick", device=None) -> dict:
    """Multi-tenant drift recovery on both driver transports (the
    in-process twin, then a server child per chip over pipes); returns
    {table: rows} (one row per (transport, chip, tenant))."""
    chips, steps, tenants = (2, 80, 3) if budget == "quick" else (3, 200, 3)
    summary = dict(budget=budget, chips=chips, steps=steps, tenants=tenants,
                   transports={})
    rows = []
    for driver_kind in ("twin", "subprocess"):
        cfg = default_runtime_config(k=4, sigma_drift=0.04, probe_every=5,
                                     driver_kind=driver_kind)
        with Timer(device) as t:
            out = simulate(chips, steps, dim=12, seed=0, cfg=cfg,
                           tenants=tenants, device=device)
        rep = out["report"]
        recoveries = _time_to_recovery(rep["events"],
                                       cfg.monitor.alarm_threshold)
        shifts = cotenant_shifts(out["trace"], rep["events"],
                                 cfg.recal_latency)
        noise = drift_noise_band(out["trace"], rep["events"],
                                 cfg.recal_latency)
        worst_shift = max((abs(s["shift"]) for s in shifts), default=0.0)
        frozen = _frozen_partial_recal(driver_kind, device=device)
        s = dict(
            wall_s=t.dt, device=out["config"]["device"],
            alarms=sum(c["alarms"] for c in rep["chips"]),
            recals=sum(c["recals"] for c in rep["chips"]),
            dropped=rep["dropped"],
            recoveries=len(recoveries),
            mean_time_to_recovery=(sum(r["ticks"] for r in recoveries)
                                   / len(recoveries)) if recoveries else None,
            recal_done_below_alarm=all(
                ev["dist_after"] < cfg.monitor.alarm_threshold
                for ev in rep["events"] if ev["event"] == "recal_done"),
            cotenant_windows=len(shifts),
            worst_cotenant_shift=worst_shift,
            drift_noise_band=noise,
            cotenants_within_noise=bool(worst_shift <= isolation_band(
                noise, cfg.monitor.clear_threshold)),
            frozen_device_check=frozen,
            per_tenant=[[dict(tenant=t_["tenant"], served=t_["served"],
                              alarms=t_["alarms"], recals=t_["recals"],
                              distance=t_["distance"])
                         for t_ in c["tenants"]] for c in rep["chips"]])
        summary["transports"][driver_kind] = s
        rows += [[driver_kind, c["chip"], t_["tenant"], t_["served"],
                  t_["alarms"], t_["recals"], f"{t_['distance']:.5f}"]
                 for c in rep["chips"] for t_ in c["tenants"]]
    _write_json("BENCH_multi_tenant.json", summary)
    for driver_kind, s in summary["transports"].items():
        assert s["recals"] > 0 and s["recal_done_below_alarm"], driver_kind
        assert s["cotenants_within_noise"], driver_kind
        assert s["frozen_device_check"]["recovered"], driver_kind
        assert s["frozen_device_check"]["cotenants_bit_identical"], \
            driver_kind
    emit("multi_tenant", ["transport", "chip", "tenant", "served", "alarms",
                          "recals", "distance"], rows)
    return {"multi_tenant": rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    ap.add_argument("--scenario", default="single",
                    choices=["single", "multi_tenant"])
    ap.add_argument("--device", default=None)
    _args = ap.parse_args()
    (multi_tenant if _args.scenario == "multi_tenant" else main)(
        _args.budget, device=_args.device)
