"""Paper Fig. 5: ZO optimizers on Parallel Mapping + the OSP error drop.

Reproduces the figure's two claims: (1) coordinate-wise ZO (ZCD/ZTP)
beats gradient-estimate ZGD on the blockwise regression; (2) the final
analytic OSP projection gives a significant error drop "for free".

Counterpart of ``benchmarks/mapping_osp.py``: a 27 × 27 weight at k = 9
(9 blocks) under a harsh post-IC frame.  On the card every probe runs the
narrow ``mesh_apply`` kernel and the per-block ``ptc_block_matmul`` route.
The device realization and every per-step ZO draw are made on the host
(:func:`draw`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import unitary as un
from ..core.mapping import parallel_map
from ..core.noise import NoiseModel
from ..device import resolve_device
from ..hw.device import sample_device
from ..optim.zo import ZOConfig
from .common import cpu_generator, emit, to_device, zo_draws

__all__ = ["METHODS", "SIZE", "K", "harsh_model", "weight", "zo_config",
           "draw", "fig5", "main"]

METHODS = ("zgd", "zcd", "ztp")
SIZE, K = 27, 9


def harsh_model() -> NoiseModel:
    """PM under a HARSH frame (extra bias residue) so ZO has work to do:
    σ_γ ×5 emulates a poorly-calibrated chip (Fig. 5's regime)."""
    return dataclasses.replace(NoiseModel().post_ic(), gamma_std=0.01,
                               crosstalk=0.01)


def weight() -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        (rng.standard_normal((SIZE, SIZE)) * 0.3).astype(np.float32))


def zo_config(budget: str) -> ZOConfig:
    steps = 1500 if budget == "quick" else 3500
    return ZOConfig(steps=steps, inner=72, delta0=8 * 2 * np.pi / 255,
                    decay=1.05, lr0=0.1)


def draw(gen: torch.Generator, cfg: ZOConfig, model: NoiseModel) -> dict:
    """One device realization of the 9 blocks (shared by the three
    methods) and each method's per-step ZO draws, (blocks, steps[, 2T])."""
    t = un.mesh_spec(K, "clements").n_rot
    b = (-(-SIZE // K)) ** 2
    out = {"dev": sample_device(gen, (b,), K, model)}
    for method in METHODS:
        out[method] = zo_draws(gen, method, (b, cfg.steps), 2 * t,
                               alt_split=t)
    return out


def fig5(w: torch.Tensor, draws: dict, cfg: ZOConfig, model: NoiseModel,
         device) -> list:
    """Rows [method, err_init, err_after_zo, err_after_osp] (means over
    blocks), unrounded."""
    rows = []
    for method in METHODS:
        pm = parallel_map(None, w, K, model, method=method, cfg=cfg,
                          dev=draws["dev"], device=device,
                          draws=draws[method])
        rows.append([method, float(pm.err_init.mean()),
                     float(pm.err_zo.mean()), float(pm.err_osp.mean())])
    return rows


def main(budget: str = "normal", device=None) -> dict:
    """Emit Fig. 5 on ``device`` (default ``cuda``); returns {table: rows}
    as the reference rounds them."""
    dev = resolve_device(device)
    cfg, model = zo_config(budget), harsh_model()
    draws = to_device(draw(cpu_generator(1), cfg, model), dev)
    rows = [[m] + [round(e, 5) for e in errs]
            for m, *errs in fig5(weight().to(dev), draws, cfg, model, dev)]
    emit("fig5_mapping_osp",
         ["zo_method", "err_init", "err_after_zo", "err_after_osp"], rows)
    return {"fig5_mapping_osp": rows}


if __name__ == "__main__":
    main()
