"""Benchmark driver of the port: one function per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--budget quick|normal] [--only SUBSTR] [--device cpu|cuda]

Counterpart of ``benchmarks/run.py`` for its six paper benchmarks
(:data:`TABLES`) and the runtime benchmarks (:data:`RUNTIME`: drift
recovery, multi-tenant, the driver transports' overhead, the served LM's
accuracy under drift, the serving gateway, the fleet autopilot).  Each
table is written under ``bench_artifacts/torch/`` and printed.  Without
``--device`` the tables run on ``cuda`` (and a host without CUDA
refuses); ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse

from ..device import resolve_device
from ..kernels import build
from . import (blocksize_tables, drift_recovery, driver_overhead,
               e2e_accuracy, fleet_autopilot, grad_fidelity, ic_convergence,
               mapping_osp, sampling_table2, scalability, serving_gateway)
from .common import Timer

__all__ = ["TABLES", "RUNTIME", "BENCHES", "run", "main"]

# the reference runner's names and order (benchmarks/run.py:63-70)
TABLES = (
    ("fig4_ic_convergence", ic_convergence.main),
    ("tables345_blocksize", blocksize_tables.main),
    ("fig5_mapping_osp", mapping_osp.main),
    ("fig8_grad_fidelity", grad_fidelity.main),
    ("table2_sampling", sampling_table2.main),
    ("fig10_scalability", scalability.main),
)
# the reference runner's runtime benchmarks, in its order
# (benchmarks/run.py:71-77)
RUNTIME = (
    ("runtime_drift_recovery", drift_recovery.main),
    ("runtime_multi_tenant", drift_recovery.multi_tenant),
    ("hw_driver_overhead", driver_overhead.main),
    ("runtime_e2e_accuracy", e2e_accuracy.main),
    ("serving_gateway", serving_gateway.main),
    ("fleet_autopilot", fleet_autopilot.main),
)
BENCHES = TABLES + RUNTIME


def run(budget: str = "quick", only: str | None = None,
        device=None, benches=BENCHES) -> list[dict]:
    """Run every benchmark of ``benches`` whose name contains ``only``;
    returns one
    record per benchmark: its ``name``, host wall ``seconds`` (the card
    synchronized at both ends), ``tables`` ({table: rows}) and
    ``launches`` (each kernel counter's increase over it)."""
    dev = resolve_device(device)
    out = []
    for name, fn in benches:
        if only and only not in name:
            continue
        print(f"\n=== {name} (budget={budget}, device={dev}) ===",
              flush=True)
        before = dict(build.launch_counts)
        with Timer(dev) as tm:
            tables = fn(budget, device=dev)
        launches = {k: build.launch_counts[k] - before[k]
                    for k in build.launch_counts
                    if build.launch_counts[k] != before[k]}
        print(f"=== {name} done in {tm.dt:.1f}s ===", flush=True)
        out.append(dict(name=name, seconds=tm.dt, tables=tables,
                        launches=launches))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the paper's tables on the PyTorch port")
    ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args(argv)
    run(args.budget, args.only, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
