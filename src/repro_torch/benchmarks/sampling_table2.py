"""Paper Table 2: PTC energy & time-step accounting for the sampling
strategies on VGG-8 / ResNet-18 (Appendix-G cost model).

The paper's α annotations are DROP sparsities; our SparsityConfig stores
KEEP densities (keep = 1 − α_paper) — rows below quote the paper's α.

Counterpart of ``benchmarks/sampling_table2.py`` on the port's profiler
(pure Python: nothing runs on a device)."""

from __future__ import annotations

from ..core.profiler import model_cost, vgg8_specs, resnet18_specs
from ..core.sparsity import SparsityConfig

from .common import emit

GIGA = 1e9


def _row(tag, specs, cfg, base=None, max_path=None):
    c = model_cost(specs, cfg, max_path=max_path)
    ratio_e = (base.e_total / c.e_total) if base else 1.0
    ratio_t = (base.t_total / c.t_total) if base else 1.0
    return [tag,
            round(c.e_fwd / GIGA, 2), round(c.e_bwd_w / GIGA, 2),
            round(c.e_bwd_x / GIGA, 2), round(c.e_total / GIGA, 2),
            round(ratio_e, 2),
            round(c.t_fwd / GIGA, 2), round(c.t_bwd_w / GIGA, 2),
            round(c.t_bwd_x / GIGA, 2), round(c.t_total / GIGA, 2),
            round(ratio_t, 2)], c


def main(budget: str = "normal", device=None) -> dict:
    """Emit Table 2 for VGG-8 and ResNet-18; returns {table: rows}.
    ``budget`` and ``device`` are accepted for the runner's uniform call
    (the cost model has neither)."""
    tables = {}
    header = ["config", "E_fwd", "E_gradW", "E_gradX", "E_total",
              "E_ratio", "T_fwd", "T_gradW", "T_gradX", "T_total",
              "T_ratio"]
    for name, specs in [("vgg8", vgg8_specs(batch=128)),
                        ("resnet18", resnet18_specs(batch=128))]:
        rows = []
        r, base = _row("SL-baseline", specs, SparsityConfig())
        rows.append(r)
        # paper: +feedback α_W=0.6 (keep 0.4)
        rows.append(_row("+feedback(a=0.6)", specs,
                         SparsityConfig(alpha_w=0.4), base)[0])
        # +column α_C=0.6 (keep 0.4)
        rows.append(_row("+column(a=0.6)", specs,
                         SparsityConfig(alpha_w=0.4, alpha_c=0.4), base)[0])
        # +data α_D=0.5
        rows.append(_row("+data(a=0.5)", specs,
                         SparsityConfig(alpha_w=0.4, alpha_c=0.4,
                                        alpha_d=0.5), base)[0])
        # RAD (spatial sampling): saves activations, NOT PTC energy/steps
        rows.append(_row("RAD(spatial,a=0.85)", specs, SparsityConfig(),
                         base)[0])
        # SWAT-U: forward+feedback weight sparsity, imbalanced paths
        p_max = max(s.grid[0] for s in specs)
        rows.append(_row("topk-imbalanced(a=0.6)", specs,
                         SparsityConfig(alpha_w=0.4, feedback_mode="topk"),
                         base, max_path=max(1, int(0.8 * p_max)))[0])
        emit(f"table2_{name}", header, rows)
        tables[f"table2_{name}"] = rows
    return tables


if __name__ == "__main__":
    main()
