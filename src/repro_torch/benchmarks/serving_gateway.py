"""Serving-gateway benchmark: continuous batching against sequential serving.

Counterpart of ``benchmarks/serving_gateway.py``.  The gateway's claim
(``repro_torch/serving/``) is that cross-request PTC frame coalescing turns
N concurrent users into one chip round trip per layer group per step, so a
photonic fleet serves more tokens per second a chip than one sequential
batch-1 ``launch.serve --hw-logits`` run per request.  Five legs, each a
function of its own:

1. :func:`throughput_leg` — one seeded open-loop workload served both ways
   on the same 2-chip fleet configuration (twin transport, σ = 0): one
   sequential batch-1 run per request, then one gateway run.  Both paths
   are warmed first.  Gates: tokens/s a chip at least 2× the sequential
   runs', and the gateway's tokens equal to theirs.
2. :func:`socket_leg` — the same identity over the socket transport (a
   device server child per chip).
3. :func:`prefill_digital` and :func:`prefill_hw` — chunked paged prefill
   on a prompt-heavy workload: TTFT in virtual steps at C = 1, 8 and 32
   (the same tokens at every C, C = 8 at least 4× faster to first token
   than C = 1), then C = 8 against C = 1 through the twin fleet (the same
   tokens in fewer frames) and over the socket (the same tokens).
4. :func:`load_sweep` — latency against offered load on the digital
   gateway, in virtual steps.
5. :func:`drift_point` — one closed-loop run at σ_drift 0.008 with
   repairs on: every request completes.

The workloads are the reference's numpy draws (:func:`workloads`) and the
parameters the port's seeded ``init_model``; the leg functions take
``params=`` so the tests can hand them the reference's.  Writes
``bench_artifacts/torch/serving_gateway.csv`` and
``BENCH_serving_gateway.json`` (the reference's keys, plus ``device``,
each leg's wall and where each token-identity check's runs first part)
and raises if a gate fails.

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_gateway \\
        [--budget quick|normal] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..device import resolve_device
from .common import ART, Timer, emit

__all__ = ["main", "workloads", "throughput_leg", "socket_leg",
           "prefill_digital", "prefill_hw", "load_sweep", "drift_point",
           "summarize", "ARCH", "SEED", "FLEET", "FLEET_K", "SLOTS", "PAGE",
           "PREFILL_PAGE", "SOCKET_PAGE", "BUDGETS"]

ARCH = "smoke:qwen3-4b"
SEED = 5
FLEET = 2
FLEET_K = 8
SLOTS = 4
PAGE = dict(page_size=8, pages=32, max_pages_per_slot=4)
PREFILL_PAGE = dict(page_size=8, pages=64, max_pages_per_slot=8)
SOCKET_PAGE = dict(page_size=8, pages=32, max_pages_per_slot=3)
DRIFT_SIGMA = 0.008
# the reference's two budgets (benchmarks/serving_gateway.py:101-111, :160)
BUDGETS = {
    "quick": dict(n_req=8, max_new=(12, 16), sweep_rates=(0.5, 1.0, 2.0, 4.0),
                  sweep_req=16, sock_req=3, sock_new=(4, 6), pre_req=6),
    "normal": dict(n_req=12, max_new=(16, 24),
                   sweep_rates=(0.25, 0.5, 1.0, 2.0, 4.0, 8.0),
                   sweep_req=32, sock_req=4, sock_new=(6, 8), pre_req=8),
}


def workloads(budget: str, vocab: int) -> dict:
    """Every leg's requests, drawn as the reference draws them: the
    throughput and drift workload, the socket identity's, the
    prompt-heavy prefill workload, the chunked socket check's, and the
    load sweep's, one per rate."""
    from ..serving.scheduler import poisson_workload

    b = BUDGETS[budget]
    return dict(
        throughput=poisson_workload(SEED, b["n_req"], 2.0, vocab,
                                    prompt_len=(4, 8), max_new=b["max_new"]),
        socket=poisson_workload(SEED + 1, b["sock_req"], 2.0, vocab,
                                prompt_len=(3, 6), max_new=b["sock_new"]),
        prefill=poisson_workload(SEED + 3, b["pre_req"], 2.0, vocab,
                                 prompt_len=(24, 44), max_new=(4, 6)),
        chunk_socket=poisson_workload(SEED + 4, 3, 2.0, vocab,
                                      prompt_len=(12, 20), max_new=(3, 4)),
        sweep={rate: poisson_workload(SEED + 2, b["sweep_req"], rate, vocab,
                                      prompt_len=(4, 8), max_new=(8, 12))
               for rate in b["sweep_rates"]})


def _fresh(reqs):
    """A run stamps its requests (lifecycle steps, ``out_tokens``), so
    every serving run gets its own copies."""
    return [dataclasses.replace(r, out_tokens=[]) for r in reqs]


def _seq_args(params, req, device, *, driver="twin"):
    return argparse.Namespace(
        arch=ARCH, batch=1, prompt_len=req.prompt_len, gen=req.max_new,
        seed=SEED, fleet=FLEET, drift=False, drift_sigma=0.0,
        probe_every=10, fleet_k=FLEET_K, fleet_dim=8, fleet_tenants=1,
        fleet_driver=driver, hw_logits=True, hw_shadow=False,
        deploy_zo=False, no_recal=True, prompt_tokens=req.prompt[None],
        params_override=params, device=device)


def _gw_args(params, reqs, device, *, hw=True, driver="twin", sigma=0.0,
             recal=False, chunk=1, page=None):
    return argparse.Namespace(
        arch=ARCH, seed=SEED, slots=SLOTS, requests=len(reqs), rate=1.0,
        max_new=(4, 12), eos_id=None, **(page or PAGE),
        prefill_chunk=chunk,
        fleet=FLEET if hw else 0, drift=sigma > 0, drift_sigma=sigma,
        probe_every=10, fleet_k=FLEET_K, fleet_driver=driver,
        hw_logits=hw, hw_shadow=False, deploy_zo=False,
        no_recal=not recal, params_override=params,
        requests_override=_fresh(reqs), device=device)


def _tokens(rep: dict) -> list[list[int]]:
    return [r["tokens"] for r in rep["requests"]]


def _first_parting(got: list, want: list) -> dict | None:
    """Where two runs' per-request tokens first differ: the request and
    the decode step; None if they are equal."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            step = next((s for s, (a, b) in enumerate(zip(g, w)) if a != b),
                        min(len(g), len(w)))
            return dict(request=i, step=step)
    return None


def _seq_sweep(params, reqs, device, *, driver="twin"):
    """One sequential batch-1 hw-logits run per request: (Σ wall_s of the
    decode loops, Σ tokens, each request's tokens)."""
    from ..launch import serve

    wall, tokens, outs = 0.0, 0, []
    for r in reqs:
        out = serve.run(_seq_args(params, r, device, driver=driver))
        wall += out["wall_s"]
        tokens += out["gen"].size
        outs.append([int(t) for t in out["gen"][0]])
    return wall, tokens, outs


def throughput_leg(params, reqs, device=None) -> dict:
    """Sequential batch-1 runs against one gateway run on the same fleet
    configuration, both warmed first (the first run of either path pays
    its lazy kernel builds and allocator growth)."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    _seq_sweep(params, reqs[:1], dev)
    gw_run(_gw_args(params, reqs[:2], dev))

    seq_wall, seq_tokens, seq_outs = _seq_sweep(params, reqs, dev)
    gw = gw_run(_gw_args(params, reqs, dev))
    seq_tps = seq_tokens / seq_wall / FLEET
    gw_tps = gw["tokens_out"] / gw["wall_s"] / FLEET
    parting = _first_parting(_tokens(gw), seq_outs)
    return dict(seq_wall=seq_wall, seq_tokens=seq_tokens, seq_outs=seq_outs,
                seq_tps=seq_tps, gw=gw, gw_outs=_tokens(gw), gw_tps=gw_tps,
                speedup=gw_tps / seq_tps, identical=parting is None,
                parting=parting)


def socket_leg(params, reqs, device=None) -> dict:
    """Sequential runs and one gateway run, every chip a socket server
    child: the gateway's tokens against the sequential runs'."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    _, _, seq = _seq_sweep(params, reqs, dev, driver="socket")
    gw = _tokens(gw_run(_gw_args(params, reqs, dev, driver="socket")))
    parting = _first_parting(gw, seq)
    return dict(seq_outs=seq, gw_outs=gw, identical=parting is None,
                parting=parting)


def prefill_digital(params, reqs, device=None, chunks=(1, 8, 32)) -> dict:
    """The digital gateway at each prefill chunk C on ``PREFILL_PAGE``:
    TTFT and busy steps (virtual steps, a function of the seeded schedule)
    and the tokens, keyed by ``str(C)``."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    ttft, busy, outs = {}, {}, {}
    for c in chunks:
        rep = gw_run(_gw_args(params, reqs, dev, hw=False, chunk=c,
                              page=PREFILL_PAGE))
        ttft[str(c)] = rep["ttft_steps"]
        busy[str(c)] = rep["busy_steps"]
        outs[str(c)] = _tokens(rep)
        print(f"prefill chunk {c:2d}: ttft p50 "
              f"{rep['ttft_steps']['p50']:5.1f} p99 "
              f"{rep['ttft_steps']['p99']:5.1f} steps | "
              f"{rep['busy_steps']} busy steps", flush=True)
    parting = next((p for p in (_first_parting(o, outs[str(chunks[0])])
                                for o in outs.values()) if p), None)
    return dict(n=len(reqs), ttft=ttft, busy_steps=busy, outs=outs,
                identical=parting is None, parting=parting)


def prefill_hw(params, reqs, page, driver="twin", device=None) -> dict:
    """The hw-logits gateway at C = 1 and C = 8 over ``driver``: the wide
    (decode + prompt chunk) frames must leave the tokens as they are."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    reps = {c: gw_run(_gw_args(params, reqs, dev, driver=driver, chunk=c,
                               page=page)) for c in (1, 8)}
    hw1, hw8 = reps[1]["fleet"]["hw"], reps[8]["fleet"]["hw"]
    parting = _first_parting(_tokens(reps[8]), _tokens(reps[1]))
    return dict(identical=parting is None, parting=parting,
                frames_c1=hw1["frames"], frames_c8=hw8["frames"],
                cols_per_frame_c1=hw1["cols_per_frame"],
                cols_per_frame_c8=hw8["cols_per_frame"])


def load_sweep(params, sweep: dict, device=None) -> list[dict]:
    """The digital gateway over each rate's workload: latency, admission
    wait and occupancy, in virtual steps."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    out = []
    for rate, wl in sweep.items():
        rep = gw_run(_gw_args(params, wl, dev, hw=False))
        lat, wait = rep["latency_steps"], rep["admission_wait_steps"]
        out.append(dict(
            rate=rate, steps=rep["steps"], busy_steps=rep["busy_steps"],
            occupancy=rep["occupancy"],
            p50_latency_steps=lat["p50"], p99_latency_steps=lat["p99"],
            p50_wait_steps=wait["p50"], p99_wait_steps=wait["p99"]))
        print(f"rate {rate:4.2f}: latency p50 {lat['p50']:5.1f} "
              f"p99 {lat['p99']:6.1f} steps | wait p99 "
              f"{wait['p99']:5.1f} | occupancy {rep['occupancy']:.2f}",
              flush=True)
    return out


def drift_point(params, reqs, device=None) -> dict:
    """One hw gateway run at σ_drift 0.008 with repairs on: tokens, alarms,
    recals, and whether every request received its full budget."""
    from ..serving.gateway import run as gw_run

    dev = resolve_device(device)
    rep = gw_run(_gw_args(params, reqs, dev, sigma=DRIFT_SIGMA, recal=True))
    chips = rep["fleet"]["chips"]
    return dict(sigma=DRIFT_SIGMA, tokens_out=rep["tokens_out"],
                alarms=sum(c["alarms"] for c in chips),
                recals=sum(c["recals"] for c in chips),
                complete=rep["tokens_out"] == sum(r.max_new for r in reqs))


def summarize(budget: str, legs: dict, walls: dict, device) -> dict:
    """The JSON's contents (the reference's keys, plus ``device`` and
    ``leg_walls_s``) from the legs' results, keyed by leg: ``throughput``,
    ``socket``, ``prefill_digital``, ``prefill_twin``, ``prefill_socket``,
    ``load_sweep`` and ``drift``."""
    tp, pre, tw = legs["throughput"], legs["prefill_digital"], \
        legs["prefill_twin"]
    gw, sweep, drift = tp["gw"], legs["load_sweep"], legs["drift"]
    ref = next(s for s in sweep if s["rate"] == 2.0)
    ttft_speedup = (pre["ttft"]["1"]["p50"]
                    / max(pre["ttft"]["8"]["p50"], 1e-9))
    gates = dict(
        speedup_ge_2x=bool(tp["speedup"] >= 2.0),
        sigma0_token_identical_twin=bool(tp["identical"]),
        sigma0_token_identical_socket=bool(legs["socket"]["identical"]),
        drift_closed_loop_completes=bool(drift["complete"]),
        chunked_token_identical_digital=bool(pre["identical"]),
        chunked_token_identical_twin=bool(tw["identical"]),
        chunked_token_identical_socket=bool(
            legs["prefill_socket"]["identical"]),
        chunked_ttft_ge_4x=bool(ttft_speedup >= 4.0),
        chunked_frames_reduced=bool(tw["frames_c8"] < tw["frames_c1"]))
    return dict(
        budget=budget, arch=ARCH, seed=SEED, fleet=FLEET, slots=SLOTS,
        page=PAGE, n_requests=len(tp["seq_outs"]), device=str(device),
        sequential=dict(wall_s=tp["seq_wall"], tokens=tp["seq_tokens"],
                        tokens_per_s_per_chip=tp["seq_tps"]),
        gateway=dict(wall_s=gw["wall_s"], tokens=gw["tokens_out"],
                     tokens_per_s_per_chip=tp["gw_tps"],
                     steps=gw["steps"], occupancy=gw["occupancy"],
                     frames_per_step=gw["fleet"]["hw"]["frames_per_step"],
                     latency_steps=gw["latency_steps"]),
        tokens_per_chip_speedup=tp["speedup"],
        load_sweep=sweep,
        ref_rate=dict(rate=ref["rate"],
                      p50_latency_steps=ref["p50_latency_steps"],
                      p99_latency_steps=ref["p99_latency_steps"]),
        drift={k: drift[k] for k in ("sigma", "tokens_out", "alarms",
                                     "recals")},
        prefill=dict(
            workload=dict(n=pre["n"], prompt_len=[24, 44], max_new=[4, 6],
                          page=PREFILL_PAGE),
            ttft=pre["ttft"], busy_steps=pre["busy_steps"],
            ttft_speedup_c8=ttft_speedup,
            twin={k: tw[k] for k in ("frames_c1", "frames_c8",
                                     "cols_per_frame_c1",
                                     "cols_per_frame_c8")}),
        partings={name: legs[name]["parting"]
                  for name in ("throughput", "socket", "prefill_digital",
                               "prefill_twin", "prefill_socket")},
        leg_walls_s=walls, gates=gates)


def main(budget: str = "quick", device=None) -> dict:
    """Every leg on ``device``; returns {table: rows, "summary": the
    JSON's contents} and raises if a gate fails."""
    import torch
    from ..configs import parse_arch
    from ..models.lm import init_model

    dev = resolve_device(device)
    cfg = parse_arch(ARCH)
    params = init_model(torch.Generator(dev).manual_seed(0), cfg)
    wl = workloads(budget, cfg.vocab)
    legs, walls = {}, {}

    def leg(name, fn, *a):
        with Timer(dev) as tm:
            legs[name] = fn(params, *a, device=dev)
        walls[name] = tm.dt
        return legs[name]

    tp = leg("throughput", throughput_leg, wl["throughput"])
    gw, frames = tp["gw"], tp["gw"]["fleet"]["hw"]
    print(f"sequential: {tp['seq_tokens']} tok in {tp['seq_wall']:.2f}s "
          f"→ {tp['seq_tps']:.2f} tok/s/chip", flush=True)
    print(f"gateway:    {gw['tokens_out']} tok in "
          f"{gw['wall_s']:.2f}s → {tp['gw_tps']:.2f} tok/s/chip "
          f"({gw['steps']} steps, occupancy "
          f"{gw['occupancy']:.2f}/{SLOTS}, "
          f"{frames['frames_per_step']:.1f} coalesced frames/step)",
          flush=True)
    print(f"speedup {tp['speedup']:.2f}× | twin token-identity: "
          f"{tp['identical']}", flush=True)
    sock = leg("socket", socket_leg, wl["socket"])
    print(f"socket token-identity (gateway ≡ sequential): "
          f"{sock['identical']}", flush=True)
    pre = leg("prefill_digital", prefill_digital, wl["prefill"])
    tw = leg("prefill_twin", prefill_hw, wl["prefill"][:4], PREFILL_PAGE,
             "twin")
    print(f"twin chunked: token-identity {tw['identical']} | frames "
          f"{tw['frames_c1']}→{tw['frames_c8']} (cols/frame "
          f"{tw['cols_per_frame_c1']:.1f}→{tw['cols_per_frame_c8']:.1f})",
          flush=True)
    sk = leg("prefill_socket", prefill_hw, wl["chunk_socket"], SOCKET_PAGE,
             "socket")
    print(f"socket chunked token-identity: {sk['identical']}", flush=True)
    sweep = leg("load_sweep", load_sweep, wl["sweep"])
    drift = leg("drift", drift_point, wl["throughput"])
    print(f"drift σ={DRIFT_SIGMA} closed loop: {drift['tokens_out']} tok, "
          f"{drift['alarms']} alarms, {drift['recals']} recals, "
          f"complete={drift['complete']}", flush=True)

    summary = summarize(budget, legs, walls, dev)
    gates = summary["gates"]
    print(f"chunked ttft speedup (C=8 vs C=1): "
          f"{summary['prefill']['ttft_speedup_c8']:.2f}× | digital "
          f"token-identity: {pre['identical']}", flush=True)
    rows = [[s["rate"], s["steps"], f"{s['occupancy']:.3f}",
             f"{s['p50_latency_steps']:.1f}", f"{s['p99_latency_steps']:.1f}",
             f"{s['p99_wait_steps']:.1f}"] for s in sweep]
    emit("serving_gateway",
         ["rate", "steps", "occupancy", "p50_latency_steps",
          "p99_latency_steps", "p99_wait_steps"], rows)
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / "BENCH_serving_gateway.json"
    path.write_text(json.dumps(summary, indent=2))
    print(f"--- serving_gateway summary ({path}) ---")
    print(json.dumps(dict(gates=gates, speedup=tp["speedup"],
                          ttft_speedup_c8=summary["prefill"][
                              "ttft_speedup_c8"],
                          p99_latency_steps=summary["ref_rate"][
                              "p99_latency_steps"]), indent=2), flush=True)
    for name, ok in gates.items():
        assert ok, f"serving gateway gate failed: {name}"
    return {"serving_gateway": rows, "summary": summary}


if __name__ == "__main__":
    _ap = argparse.ArgumentParser()
    _ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    _ap.add_argument("--device", default=None)
    _a = _ap.parse_args()
    main(_a.budget, device=_a.device)
