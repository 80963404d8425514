"""Paper Fig. 10 / Table 1: scalability of on-chip training protocols.

Prior ZO protocols spend O(#params) PTC queries PER STEP on stochastic
loss probes (FLOPS: q gradient samples × forward; MixedTrn: sparse
mixed ZO); L²ight's SL needs a CONSTANT 3 passes (fwd + 2 reciprocal)
regardless of parameter count, and IC/PM are one-off deterministic
costs.  We count PTC calls per optimization step for growing model sizes
— the 3-order-of-magnitude scalability gap is structural.

Counterpart of ``benchmarks/scalability.py`` on the port's profiler (pure
Python: nothing runs on a device)."""

from __future__ import annotations

from ..core.profiler import LayerSpec, layer_cost
from ..core.sparsity import SparsityConfig

from .common import emit


def protocol_cost_per_step(n_params: int, d: int, n_cols: int, k: int = 9):
    """PTC calls per optimization step for each protocol on an
    n_params≈d² single layer processing n_cols columns."""
    spec = LayerSpec("l", c_out=d, c_in_eff=d, n_cols=n_cols, k=k)
    p, q = spec.grid
    fwd = p * q * n_cols
    out = {}
    # BFT: brute-force per-device tuning — 2 probes per parameter, each a
    # full forward
    out["BFT"] = 2 * n_params * fwd
    # FLOPS (ZO grad est., q=5 samples): (q+1) forwards per step
    out["FLOPS"] = 6 * fwd
    # MixedTrn: sparse ZO (10% params perturbed) + sparse probes
    out["MixedTrn"] = 2 * max(1, int(0.1 * n_params)) * fwd // 10
    # L²ight SL: fwd + 2 reciprocal passes (weight grad) + feedback
    c = layer_cost(spec, SparsityConfig(alpha_w=0.4, alpha_c=0.4))
    out["L2ight"] = c.e_total
    return out


def main(budget: str = "normal", device=None) -> dict:
    """Emit Fig. 10 and Table 1; returns {table: rows}.  ``budget`` and
    ``device`` are accepted for the runner's uniform call."""
    rows = []
    for d in [16, 64, 256, 1024, 3162]:     # ~10² … ~10⁷ params
        n_params = d * d
        costs = protocol_cost_per_step(n_params, d, n_cols=256)
        rows.append([n_params] + [f"{costs[k]:.3g}" for k in
                                  ["BFT", "FLOPS", "MixedTrn", "L2ight"]]
                    + [f"{costs['MixedTrn'] / costs['L2ight']:.1f}"])
    tables = {"fig10_scalability": rows}
    emit("fig10_scalability",
         ["n_params", "BFT_calls/step", "FLOPS_calls/step",
          "MixedTrn_calls/step", "L2ight_calls/step",
          "MixedTrn/L2ight"], rows)
    # Table 1 qualitative row
    tables["table1_protocols"] = [
        ["BFT", "~100", "ZO", "medium", "coh-IO"],
        ["PSO", "~100", "ZO", "high", "coh-IO"],
        ["AVM", "~100", "FO", "medium", "coh-IO+per-device"],
        ["FLOPS", "~1000", "ZO", "high", "coh-IO"],
        ["MixedTrn", "~2500", "ZO", "medium", "coh-IO"],
        ["L2ight", "~10M (demonstrated 30B-param LM dry-run)",
         "ZO+FO", "medium", "coh-IO"]]
    emit("table1_protocols",
         ["protocol", "max_params", "algorithm", "resolution",
          "observability"], tables["table1_protocols"])
    return tables


if __name__ == "__main__":
    main()
