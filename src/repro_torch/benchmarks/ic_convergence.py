"""Paper Fig. 4(b): ZO optimizer comparison on Identity Calibration.

Compares ZGD / ZCD / ZTP (all with best-solution recording) at k=9 under
the full noise model; emits the best-loss trace and final |U|-MSE.

Counterpart of ``benchmarks/ic_convergence.py``: 4 blocks, 2 restarts.  On
the card every probe realizes U and V through the narrow ``mesh_apply``
kernel and measures them through the per-block ``ptc_block_matmul``
route.  The device realization and every per-step ZO draw are made on the
host (:func:`draw`) and handed to ``calibrate_identity``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import unitary as un
from ..core.calibration import calibrate_identity
from ..core.noise import NoiseModel
from ..device import resolve_device
from ..hw.device import sample_device
from ..optim.zo import ZOConfig
from .common import cpu_generator, emit, to_device, zo_draws

__all__ = ["METHODS", "N_BLOCKS", "K", "RESTARTS", "zo_config", "draw",
           "fig4", "main"]

METHODS = ("zgd", "zcd", "ztp")
N_BLOCKS, K, RESTARTS = 4, 9, 2


def zo_config(budget: str) -> ZOConfig:
    steps = 1200 if budget == "quick" else 2400
    return ZOConfig(steps=steps // 2, inner=72, delta0=0.5, decay=1.05,
                    lr0=0.3, record_every=steps // 20)


def draw(gen: torch.Generator, cfg: ZOConfig, model: NoiseModel) -> dict:
    """One device realization (shared by the three methods, as the
    reference's one key gives them) and each method's per-restart ZO
    draws, (restarts, blocks, steps[, 2T])."""
    n = 2 * un.mesh_spec(K, "clements").n_rot
    out = {"dev": sample_device(gen, (N_BLOCKS,), K, model)}
    for method in METHODS:
        out[method] = zo_draws(gen, method, (RESTARTS, N_BLOCKS, cfg.steps),
                               n)
    return out


def fig4(draws: dict, cfg: ZOConfig, model: NoiseModel, device) -> list:
    """Rows [method, final surrogate loss, identity MSE, best-loss trace
    (blocks' mean)], unrounded."""
    rows = []
    for method in METHODS:
        res = calibrate_identity(None, N_BLOCKS, K, model, method=method,
                                 cfg=cfg, dev=draws["dev"],
                                 restarts=RESTARTS, device=device,
                                 draws=draws[method])
        mse = (float(res.mse_u.mean()) + float(res.mse_v.mean())) / 2
        trace = res.history.mean(0).cpu().numpy()
        rows.append([method, float(res.loss.mean()), mse, trace])
    return rows


def main(budget: str = "normal", device=None) -> dict:
    """Emit Fig. 4(b) on ``device`` (default ``cuda``); returns {table:
    rows} as the reference rounds them."""
    dev = resolve_device(device)
    cfg, model = zo_config(budget), NoiseModel()
    draws = to_device(draw(cpu_generator(0), cfg, model), dev)
    rows = []
    for method, loss, mse, trace in fig4(draws, cfg, model, dev):
        stride = max(1, len(trace) // 8)
        rows.append([method, round(loss, 5), round(mse, 4),
                     " ".join(f"{v:.4f}" for v in np.asarray(trace)[::stride])])
    emit("fig4_ic_convergence",
         ["method", "final_surrogate_loss", "identity_mse(T4:k9=0.013)",
          "loss_trace"], rows)
    return {"fig4_ic_convergence": rows}


if __name__ == "__main__":
    main()
