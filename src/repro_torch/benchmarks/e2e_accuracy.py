"""End-to-end task accuracy under drift: LM logits on the photonic fleet.

Counterpart of ``benchmarks/e2e_accuracy.py``: the metric the paper cares
about is the served model's task accuracy under hardware drift, not a
probe or mapping distance.  The benchmark closes that loop end to end:

1. **Train** the smoke LM (digital, eager) on the synthetic order-1
   Markov stream until it predicts legal successors reliably
   (:func:`_train_model`).
2. **Deploy** every PTC layer of the trained model onto a 2-chip photonic
   fleet (one tenant per layer) and serve teacher-forced decode through
   the routed chips' realized transfer (``launch.serve --hw-logits``).
3. **Sweep σ_drift** with the closed loop on (probe → alarm → batch
   partial recalibration) and off, scoring *legality accuracy*: the
   fraction of positions whose argmax is one of the Markov table's legal
   successors of the context token (:func:`_legality`).

Four gates (:func:`gates`): route ≡ shadow tokens at σ = 0 on the
untrained model, bit-identical logits across the twin, subprocess and
socket transports on the trained one, the open loop degrading
monotonically with σ, and the closed loop's tail accuracy within 0.01 of
the σ = 0 baseline at every σ.

The parameters come from a CPU generator seeded by :data:`SEED` and move
to the device, so every device starts from the same weights.  Writes
``bench_artifacts/torch/e2e_accuracy.csv`` and ``BENCH_e2e_accuracy.json``
(the reference's keys, plus ``device``, ``leg_walls_s`` and
``partings``: where route and shadow, and each stream transport and the
twin, first part) and raises after writing them if a gate fails.

    PYTHONPATH=src python -m repro_torch.benchmarks.e2e_accuracy \\
        [--budget quick|normal] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from .common import ART, Timer, emit, to_device

__all__ = ["main", "gates", "summarize", "ARCH",
           "SEED", "FLEET", "FLEET_K", "BUDGETS", "TRANSPORTS"]

ARCH = "smoke:qwen3-4b"
SEED = 3
FLEET = 2
FLEET_K = 8
# the reference's two budgets (benchmarks/e2e_accuracy.py:159-171); σ tops
# out at 0.014: beyond it the drift between probe ticks outruns the repair
# cadence, and the recovery gate would measure the probe budget
BUDGETS = {
    "quick": dict(train_steps=200, batch=6, stream_len=49, tail=24,
                  sigmas=(0.004, 0.008, 0.014), conf_len=9),
    "normal": dict(train_steps=400, batch=8, stream_len=81, tail=40,
                   sigmas=(0.003, 0.006, 0.01, 0.014), conf_len=13),
}
TRANSPORTS = ("twin", "subprocess", "socket")


def _init_params(cfg, device) -> dict:
    """The seeded initial parameters, drawn on the CPU and moved to
    ``device``."""
    from ..models.lm import init_model

    return to_device(init_model(torch.Generator("cpu").manual_seed(SEED),
                                cfg), device)


def _train_model(cfg, steps: int, batch: int = 16, seq: int = 32,
                 lr: float = 2e-3, device=None, params=None):
    """Digitally train the smoke LM on the Markov stream: ``steps`` AdamW
    steps from ``params`` (None: the seeded init) on ``lm_batch(SEED, i)``;
    returns (params, the last step's loss).  The step draws nothing: the
    benchmark trains without sparsity."""
    from ..data.synthetic import lm_batch
    from ..launch.steps import build_update_step, flatten
    from ..models.lm import model_trainable_mask
    from ..optim.optimizers import AdamWConfig, init_opt_state

    dev = resolve_device(device)
    params = _init_params(cfg, dev) if params is None else to_device(params,
                                                                     dev)
    opt = init_opt_state(flatten(params),
                         flatten(model_trainable_mask(params)))
    step = build_update_step(cfg, AdamWConfig(lr=lr))
    loss = float("nan")
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in lm_batch(SEED, i, batch, seq, cfg.vocab).items()}
        params, opt, loss_t, _ = step(params, opt, b)
        loss = float(loss_t)
    return params, loss


def _runtime_cfg(sigma: float, driver_kind: str = "twin"):
    """Closed-loop policy tuned for hw-logits serving: hysteresis just
    above the ~0.005 OSP deployment floor, probes every other tick, and
    *batch* partial recalibration (one chip outage re-tunes every alarmed
    layer: a served model's tenants drift together)."""
    from ..core.noise import DEFAULT_NOISE
    from ..hw.drift import DriftConfig
    from ..runtime.fleet import RuntimeConfig
    from ..runtime.monitor import MonitorConfig
    from ..runtime.recalibrate import RecalConfig

    # hysteresis sits around the warm-recal floor (d ≈ 0.003 with the
    # gentle ZCD schedule) and the probe estimator's noise at n = 24, so
    # repairs clear instead of re-queuing on estimator noise
    mon = MonitorConfig(n_probes=24, alarm_threshold=0.010,
                        clear_threshold=0.006, consecutive=2)
    return RuntimeConfig(
        k=FLEET_K, noise=DEFAULT_NOISE.post_ic(),
        drift=DriftConfig(sigma_phase=sigma, theta=0.01), monitor=mon,
        recal=RecalConfig(zo_steps=200, delta0=0.02, decay=1.02),
        probe_every=2, recal_latency=1, max_concurrent_recals=1,
        driver_kind=driver_kind, router_policy="drift_aware",
        repair_batch=64)


def _serve_args(params, stream, sigma: float, *, recal: bool = True,
                mode: str = "route", driver: str = "twin",
                trace_logits: bool = False, device=None):
    return argparse.Namespace(
        arch=ARCH, batch=int(stream.shape[0]),
        prompt_len=int(stream.shape[1]), gen=0, seed=SEED,
        fleet=FLEET, drift=sigma > 0, drift_sigma=sigma, probe_every=2,
        fleet_k=FLEET_K, fleet_dim=8, fleet_tenants=1, fleet_driver=driver,
        hw_logits=(mode == "route"), hw_shadow=(mode == "shadow"),
        deploy_zo=False, no_recal=not recal, trace_logits=trace_logits,
        prompt_tokens=stream, runtime_cfg=_runtime_cfg(sigma, driver),
        params_override=params, device=device)


def _legality(preds: np.ndarray, stream: np.ndarray,
              table: np.ndarray) -> np.ndarray:
    """(B, S) bool: the prediction at position i is a legal successor of
    the forced context token at i."""
    ctx = stream[:, :preds.shape[1]]
    return (table[ctx] == preds[..., None]).any(-1)


def _run(params, stream, table, sigma, tail, **kw):
    """One ``launch.serve`` run of ``stream`` at ``sigma``: (its row of the
    reference's keys, serve's output)."""
    from ..launch import serve as serve_mod

    t0 = time.perf_counter()
    out = serve_mod.run(_serve_args(params, stream, sigma, **kw))
    ok = _legality(out["preds"], stream, table)
    rep = out["report"]
    return dict(
        sigma=sigma,
        accuracy=float(ok.mean()),
        tail_accuracy=float(ok[:, -tail:].mean()),
        alarms=sum(c["alarms"] for c in rep["chips"]),
        recals=sum(c["recals"] for c in rep["chips"]),
        recal_ptc_calls=sum(c["recal_ptc_calls"] for c in rep["chips"]),
        serve_ptc_calls=sum(c["serve_ptc_calls"] for c in rep["chips"]),
        max_probe_distance=max(t["distance"] for c in rep["chips"]
                               for t in c["tenants"]),
        frames_per_step=rep["hw"]["frames_per_step"],
        dropped_passes=rep["hw"]["dropped_passes"],
        shadow_calls=rep["hw"]["shadow_calls"],
        wall_s=time.perf_counter() - t0), out


def _first_parting(got: np.ndarray, want: np.ndarray) -> dict | None:
    """The first (request, position) where two (B, S, ...) traces differ;
    None if they are equal."""
    if np.array_equal(got, want):
        return None
    diff = (got != want).reshape(got.shape[0], got.shape[1], -1).any(-1)
    b, i = np.argwhere(diff)[0]
    return dict(request=int(b), position=int(i))


def gates(base: dict, sweep: list[dict], sigma0_identical: bool,
          transport_identical: bool) -> dict:
    """The reference's four gates (benchmarks/e2e_accuracy.py:240-250):
    the open loop monotone within 0.01 and its top σ more than 0.02 below
    the baseline, every closed-loop tail at least the baseline's tail less
    0.01."""
    open_accs = [s["open"]["accuracy"] for s in sweep]
    monotone = all(open_accs[i + 1] <= open_accs[i] + 0.01
                   for i in range(len(open_accs) - 1))
    degrades = open_accs[-1] < base["accuracy"] - 0.02
    recovers = all(s["closed"]["tail_accuracy"]
                   >= base["tail_accuracy"] - 0.01 for s in sweep)
    return dict(
        sigma0_token_identical=bool(sigma0_identical),
        transport_bit_identical=bool(transport_identical),
        open_loop_monotone=bool(monotone and degrades),
        closed_loop_recovers=bool(recovers))


def summarize(budget: str, loss: float, base: dict, n_layers: int,
              transports: dict, sweep: list[dict], gate: dict, walls: dict,
              partings: dict, device) -> dict:
    """The JSON's contents: the reference's keys, plus ``device``,
    ``leg_walls_s`` and ``partings``."""
    b = BUDGETS[budget]
    return dict(
        budget=budget, arch=ARCH, seed=SEED, train_steps=b["train_steps"],
        train_loss=loss, batch=b["batch"], stream_len=b["stream_len"],
        tail=b["tail"], fleet=FLEET, fleet_k=FLEET_K,
        n_ptc_layers=n_layers, frames_per_step=base["frames_per_step"],
        baseline=base, transports=transports, sweep=sweep, gates=gate,
        device=str(device), leg_walls_s=walls, partings=partings)


def _rows(base: dict, sweep: list[dict]) -> list[list]:
    rows = [[0.0, f"{base['accuracy']:.4f}", f"{base['tail_accuracy']:.4f}",
             base["recals"], f"{base['accuracy']:.4f}",
             f"{base['tail_accuracy']:.4f}",
             f"{base['max_probe_distance']:.4f}"]]
    for s in sweep:
        rows.append([s["sigma"],
                     f"{s['closed']['accuracy']:.4f}",
                     f"{s['closed']['tail_accuracy']:.4f}",
                     s["closed"]["recals"],
                     f"{s['open']['accuracy']:.4f}",
                     f"{s['open']['tail_accuracy']:.4f}",
                     f"{s['open']['max_probe_distance']:.4f}"])
    return rows


def main(budget: str = "quick", device=None) -> dict:
    """Train, then every serve run on ``device``; returns
    {"e2e_accuracy": rows, "summary": the JSON's contents} and raises
    after writing the JSON if a gate fails."""
    from ..configs import parse_arch
    from ..data.synthetic import _markov_table, lm_batch

    dev = resolve_device(device)
    b = BUDGETS[budget]
    tail = b["tail"]
    cfg = parse_arch(ARCH)
    table = _markov_table(cfg.vocab, SEED)
    walls = {}
    with Timer(dev) as tm:
        params, loss = _train_model(cfg, b["train_steps"], device=dev)
    walls["train"] = tm.dt
    print(f"trained {ARCH} for {b['train_steps']} steps "
          f"(loss {loss:.4f}, {tm.dt:.1f}s)", flush=True)

    stream = lm_batch(SEED, 999, b["batch"], b["stream_len"],
                      cfg.vocab)["tokens"]

    # -- σ = 0 (loop off: a noise-tripped repair would rewrite phases away
    # from the deployment state the shadow path mirrors) ---------------------
    base, base_out = _run(params, stream, table, 0.0, tail, mode="route",
                          recal=False, device=dev)
    walls["base"] = base["wall_s"]
    print(f"σ=0: hw accuracy {base['accuracy']:.4f} "
          f"(tail {base['tail_accuracy']:.4f})", flush=True)

    # Token identity is gated on the UNTRAINED model: training this task
    # drives the 4 legal successors toward equal logits, so its argmax
    # sits on ~1e-7 margins and flips on contraction order, a property of
    # the task, not of the serving path.  The random-init model has sharp
    # margins, so route ≡ shadow is a meaningful path gate there.
    params0 = _init_params(cfg, dev)
    id_stream = stream[:2, :b["conf_len"]]
    idr, idr_out = _run(params0, id_stream, table, 0.0, tail=4,
                        mode="route", recal=False, device=dev)
    ids, ids_out = _run(params0, id_stream, table, 0.0, tail=4,
                        mode="shadow", recal=False, device=dev)
    walls["identity"] = idr["wall_s"] + ids["wall_s"]
    partings = dict(route_shadow=_first_parting(idr_out["preds"],
                                                ids_out["preds"]))
    sigma0_identical = partings["route_shadow"] is None
    print(f"σ=0 token-identity (route ≡ shadow, untrained model): "
          f"{sigma0_identical}", flush=True)

    conf_stream = stream[:2, :b["conf_len"]]
    transports = {}
    ref_logits = None
    for driver in TRANSPORTS:
        r, out = _run(params, conf_stream, table, 0.0, tail=4, mode="route",
                      driver=driver, recal=False, trace_logits=True,
                      device=dev)
        walls[f"transport_{driver}"] = r["wall_s"]
        transports[driver] = dict(wall_s=r["wall_s"], accuracy=r["accuracy"])
        # (steps, B, V) → (B, steps, V)
        logits = out["logits"].swapaxes(0, 1)
        if ref_logits is None:
            ref_logits = logits
        else:
            partings[driver] = _first_parting(logits, ref_logits)
            transports[driver]["bit_identical_to_twin"] = \
                partings[driver] is None
    transport_identical = all(partings[d] is None for d in TRANSPORTS[1:])
    print(f"transport bit-identity (twin≡subprocess≡socket): "
          f"{transport_identical}", flush=True)

    # -- accuracy vs drift, closed and open loop -----------------------------
    sweep = []
    for sigma in b["sigmas"]:
        closed, _ = _run(params, stream, table, sigma, tail, recal=True,
                         device=dev)
        open_, _ = _run(params, stream, table, sigma, tail, recal=False,
                        device=dev)
        walls[f"closed_{sigma}"] = closed["wall_s"]
        walls[f"open_{sigma}"] = open_["wall_s"]
        sweep.append(dict(sigma=sigma, closed=closed, open=open_))
        print(f"σ={sigma}: closed acc {closed['accuracy']:.4f} "
              f"(tail {closed['tail_accuracy']:.4f}, {closed['alarms']} "
              f"alarms, {closed['recals']} recals) | open acc "
              f"{open_['accuracy']:.4f} (tail {open_['tail_accuracy']:.4f}, "
              f"{open_['alarms']} alarms)", flush=True)

    gate = gates(base, sweep, sigma0_identical, transport_identical)
    rows = _rows(base, sweep)
    emit("e2e_accuracy",
         ["sigma", "closed_acc", "closed_tail_acc", "closed_recals",
          "open_acc", "open_tail_acc", "open_max_probe_dist"], rows)
    summary = summarize(budget, loss, base,
                        len(base_out["report"]["hw"]["layers"]), transports,
                        sweep, gate, walls, partings, dev)
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / "BENCH_e2e_accuracy.json"
    path.write_text(json.dumps(summary, indent=2))
    print(f"--- e2e_accuracy summary ({path}) ---")
    print(json.dumps(dict(gates=gate, baseline_accuracy=base["accuracy"],
                          baseline_tail=base["tail_accuracy"]), indent=2),
          flush=True)
    for name, ok in gate.items():
        if not ok:
            raise AssertionError(f"e2e accuracy gate failed: {name}")
    return {"e2e_accuracy": rows, "summary": summary}


if __name__ == "__main__":
    _ap = argparse.ArgumentParser()
    _ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    _ap.add_argument("--device", default=None)
    _a = _ap.parse_args()
    main(_a.budget, device=_a.device)
