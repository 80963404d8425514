"""Benchmark-regression gate: compare fresh bench JSON against baselines.

Counterpart of ``benchmarks/check_regression.py`` over the port's
artifacts (``bench_artifacts/torch/`` by default): the same ``SPECS``, the
same checks, the same messages.

* **Throughput / accuracy metrics** — host-speed-invariant numbers
  (stream-vs-twin throughput ratios, task accuracy, virtual-step
  latencies) from the current run are compared against a baseline
  directory; a drop of more than ``--max-regression`` (default 25%) fails.
  Absolute rates are not gated: only same-host ratios and seeded
  schedules carry signal across machines.
* **Boolean gates** — bit-identity and acceptance flags written by the
  benchmarks themselves.  A gate that is false, or missing (the check
  that writes it no longer runs), fails.

No baseline of the port is committed.  Save a run's artifacts and compare
a later run against them::

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only serving_gateway
    cp -r bench_artifacts/torch bench_artifacts/torch_baseline
    ... (change, rerun) ...
    PYTHONPATH=src python -m repro_torch.benchmarks.check_regression \\
        --baseline bench_artifacts/torch_baseline \\
        --require BENCH_serving_gateway.json
    PYTHONPATH=src python -m repro_torch.benchmarks.check_regression \\
        --baseline bench_artifacts/torch_baseline --self-test

Against a directory without the file (an empty one, say) the gates are
checked and the metrics skipped.  ``--self-test`` proves the gate is
live: it writes a degraded copy of the current artifacts (throughput
halved, gates flipped), runs the same check on it, and fails unless the
check rejects it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from .common import ART

__all__ = ["SPECS", "check", "main"]


def _max_batch(d: dict) -> str:
    return str(max(int(k) for k in d["twin"]["batch_sweep"]))


def _batch_speedup(d: dict, transport: str) -> float:
    """Probe throughput at max batch size over batch-1 throughput, on
    ONE transport.  Both numerator and denominator ride the same host,
    process, and load, so the ratio is far more repeatable than any
    cross-transport comparison (measured: single-op stream/twin ratios
    swing ±45% run-to-run on a busy 2-core host; same-transport
    amortization swings ≲20%) — while a genuine v3 data-plane
    regression (lost batching, lost pipelining, per-op round-trips
    back) collapses it ~10×, far past any tolerance."""
    bs = d[transport]["batch_sweep"]
    n = _max_batch(d)
    return bs[n]["probe_cols_per_s"] / bs["1"]["probe_cols_per_s"]


# Per-artifact spec: host-invariant higher-is-better metrics + boolean
# gate paths.  Files absent from BOTH dirs are skipped; a file present
# in the baseline but missing from the current run is only an error
# when listed via --require (bench-smoke produces a subset of the
# nightly artifact set).
def _amortization_geomean(d: dict) -> float:
    """Geometric mean of the three transports' batch amortization.
    Averaging across transports cancels most residual host jitter
    (measured ~4% run-to-run vs 7-17% per transport), while a real
    data-plane regression on even ONE transport (~10× collapse) still
    drops the geomean >50% — far past the 25% gate."""
    prod = 1.0
    for t in ("twin", "subprocess", "socket"):
        prod *= _batch_speedup(d, t)
    return prod ** (1.0 / 3.0)


SPECS = {
    "BENCH_driver_overhead.json": dict(
        metrics={
            "batch_amortization_geomean": _amortization_geomean,
            # raw batch-64 socket-vs-twin throughput ratio: the boolean
            # acceptance gate below adapts its threshold to the host's
            # core count, so this same-run ratio is ALSO drop-gated to
            # catch data-plane regressions that stay above the adaptive
            # floor (e.g. binary framing silently falling back to
            # base64 would roughly halve it)
            "socket_batch64_vs_twin_batch64":
                lambda d: d["socket_batch64_vs_twin_batch64"],
        },
        # v4 additions: v4≡v3 framing identity, every-concurrent-session
        # identity, and the batch-64 socket-within-2×-twin throughput
        # acceptance gate — all booleans computed by the benchmark run
        # itself, so "missing" means the check silently stopped running
        gates=["bit_identity_ok",
               "v4_v3_bit_identical",
               "concurrent_bit_identical",
               "v4_socket_batch64_within_2x_twin"],
    ),
    "BENCH_e2e_accuracy.json": dict(
        metrics={
            "baseline_accuracy": lambda d: d["baseline"]["accuracy"],
            "baseline_tail_accuracy":
                lambda d: d["baseline"]["tail_accuracy"],
        },
        gates=["gates.sigma0_token_identical",
               "gates.transport_bit_identical",
               "gates.open_loop_monotone",
               "gates.closed_loop_recovers"],
    ),
    "BENCH_serving_gateway.json": dict(
        metrics={
            # gateway vs sequential tokens/s-per-chip on the SAME fleet,
            # host, and workload: the continuous-batching dividend.  Both
            # sides ride one process, so the ratio is host-invariant the
            # same way the driver-overhead amortization is.
            "tokens_per_chip_speedup":
                lambda d: d["tokens_per_chip_speedup"],
            # p99 request latency in VIRTUAL STEPS at the reference
            # offered load — a pure function of the (seeded) schedule,
            # bit-deterministic across hosts.  Inverted: higher is
            # better, so a latency blow-up trips the drop gate.
            "inv_p99_latency_steps":
                lambda d: 1.0 / d["ref_rate"]["p99_latency_steps"],
            # chunked-prefill dividend: C=1 over C=8 TTFT p50 on the
            # prompt-heavy workload, in virtual steps — the ≥4× gate
            # below is the floor, this drop-gates erosion above it
            "chunked_ttft_speedup_c8":
                lambda d: d["prefill"]["ttft_speedup_c8"],
            # inverted absolute TTFT at C=8 (virtual steps, seeded
            # schedule → bit-deterministic): higher is better, so a
            # prefill slowdown that ALSO slowed the C=1 side (keeping
            # the ratio flat) still trips this one
            "inv_chunked_ttft_p50":
                lambda d: 1.0 / max(d["prefill"]["ttft"]["8"]["p50"], 1e-9),
        },
        gates=["gates.speedup_ge_2x",
               "gates.sigma0_token_identical_twin",
               "gates.sigma0_token_identical_socket",
               "gates.drift_closed_loop_completes",
               "gates.chunked_token_identical_digital",
               "gates.chunked_token_identical_twin",
               "gates.chunked_token_identical_socket",
               "gates.chunked_ttft_ge_4x",
               "gates.chunked_frames_reduced"],
    ),
    "BENCH_fleet_autopilot.json": dict(
        metrics={
            # all three ride the seeded virtual-tick schedule, so they
            # are bit-deterministic across hosts: SLO attainment under
            # the autopilot, inverted p99 queue latency (higher is
            # better → a latency blow-up trips the drop gate), and the
            # fraction of reactive alarms the forecast averted
            "slo_attainment_autopilot":
                lambda d: d["autopilot"]["slo_attainment"],
            "inv_p99_latency_autopilot":
                lambda d: 1.0 / max(d["autopilot"]["p99_latency"], 1e-9),
            "alarms_averted_frac": lambda d: d["alarms_averted_frac"],
        },
        gates=["gates.autopilot_accuracy_no_worse",
               "gates.fewer_reactive_alarms",
               "gates.recal_budget_within_envelope",
               "gates.sensitivity_rank_validated",
               "gates.gateway_autopilot_completes"],
    ),
}


def _lookup(d: dict, dotted: str):
    for part in dotted.split("."):
        if not isinstance(d, dict) or part not in d:
            return None
        d = d[part]
    return d


def check(baseline_dir: str, current_dir: str, max_regression: float,
          require: list[str]) -> list[str]:
    """Returns a list of failure messages (empty = pass)."""
    failures: list[str] = []
    checked_any = False
    for fname, spec in SPECS.items():
        base_path = os.path.join(baseline_dir, fname)
        cur_path = os.path.join(current_dir, fname)
        if not os.path.exists(cur_path):
            if fname in require:
                failures.append(f"{fname}: required artifact missing from "
                                f"current run ({cur_path})")
            continue
        with open(cur_path) as f:
            cur = json.load(f)
        checked_any = True

        for gate in spec["gates"]:
            val = _lookup(cur, gate)
            if val is None:
                failures.append(f"{fname}: gate {gate!r} missing — the "
                                f"check that writes it no longer runs")
            elif not val:
                failures.append(f"{fname}: gate {gate!r} is FALSE")

        if not os.path.exists(base_path):
            print(f"{fname}: no baseline — gates checked, metrics skipped")
            continue
        with open(base_path) as f:
            base = json.load(f)
        for name, fn in spec["metrics"].items():
            try:
                b, c = float(fn(base)), float(fn(cur))
            except (KeyError, TypeError) as e:
                failures.append(f"{fname}: metric {name} unreadable: {e!r}")
                continue
            drop = (b - c) / b if b > 0 else 0.0
            status = "FAIL" if drop > max_regression else "ok"
            print(f"{fname}: {name}: baseline {b:.4f} → current {c:.4f} "
                  f"({-drop:+.1%}) [{status}]")
            if drop > max_regression:
                failures.append(
                    f"{fname}: {name} regressed {drop:.1%} "
                    f"(baseline {b:.4f} → {c:.4f}, limit "
                    f"{max_regression:.0%})")
    if not checked_any:
        failures.append(f"no known benchmark artifacts found in "
                        f"{current_dir} — nothing was gated")
    return failures


def _degrade(src_dir: str, dst_dir: str) -> None:
    """Synthesize a regressed artifact set: halve one throughput ratio
    and flip one boolean gate in every known file present."""
    os.makedirs(dst_dir, exist_ok=True)
    for fname in SPECS:
        path = os.path.join(src_dir, fname)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            d = json.load(f)
        if fname == "BENCH_driver_overhead.json":
            # a lost-batching regression: max-batch throughput collapses
            # toward the per-op rate on one transport (geomean −54%)
            n = _max_batch(d)
            d["subprocess"]["batch_sweep"][n]["probe_cols_per_s"] *= 0.1
            d["socket_batch64_vs_twin_batch64"] *= 0.4
            d["bit_identity_ok"] = False
            d["concurrent_bit_identical"] = False
            d["v4_socket_batch64_within_2x_twin"] = False
        if fname == "BENCH_e2e_accuracy.json":
            d["baseline"]["accuracy"] *= 0.5
            d["gates"]["closed_loop_recovers"] = False
        if fname == "BENCH_serving_gateway.json":
            # a lost-coalescing regression: the gateway degenerates to
            # sequential throughput and tail latency blows up
            d["tokens_per_chip_speedup"] *= 0.4
            d["ref_rate"]["p99_latency_steps"] *= 3.0
            d["gates"]["sigma0_token_identical_twin"] = False
            # a chunked-prefill regression: ingestion degenerates back
            # toward one token/step (TTFT inflates, ratio collapses)
            # and the wide-frame path diverges from the legacy tokens
            d["prefill"]["ttft"]["8"]["p50"] *= 5.0
            d["prefill"]["ttft_speedup_c8"] *= 0.2
            d["gates"]["chunked_token_identical_digital"] = False
        if fname == "BENCH_fleet_autopilot.json":
            # a broken-forecast regression: the autopilot degenerates to
            # reactive (no alarms averted, SLO halves) and a scheduler
            # bug lets proactive spend blow the envelope
            d["autopilot"]["slo_attainment"] *= 0.5
            d["alarms_averted_frac"] = 0.0
            d["gates"]["fewer_reactive_alarms"] = False
            d["gates"]["recal_budget_within_envelope"] = False
        with open(os.path.join(dst_dir, fname), "w") as f:
            json.dump(d, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="directory holding the committed BENCH_*.json "
                         "baselines")
    ap.add_argument("--current", default=str(ART),
                    help="directory holding the fresh run's artifacts "
                         "(default: bench_artifacts/torch)")
    ap.add_argument("--max-regression", type=float, default=0.25,
                    help="relative drop that fails the gate (default 25%%)")
    ap.add_argument("--require", nargs="*", default=[],
                    help="artifact files that MUST be present in the "
                         "current run")
    ap.add_argument("--self-test", action="store_true",
                    help="prove the gate is live: degrade a copy of the "
                         "current artifacts and require the check to fail")
    args = ap.parse_args(argv)

    if args.self_test:
        tmp = tempfile.mkdtemp(prefix="bench_degraded_")
        try:
            _degrade(args.current, tmp)
            failures = check(args.baseline, tmp, args.max_regression,
                             args.require)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if failures:
            print(f"self-test OK: degraded artifacts rejected with "
                  f"{len(failures)} failure(s):")
            for msg in failures:
                print(f"  - {msg}")
            return 0
        print("self-test FAILED: degraded artifacts passed the gate")
        return 1

    failures = check(args.baseline, args.current, args.max_regression,
                     args.require)
    if failures:
        print("\nbenchmark regression gate FAILED:")
        for msg in failures:
            print(f"  - {msg}")
        return 1
    print("\nbenchmark regression gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
