"""Closed-loop recalibration: incremental ZO + OSP refresh (+ in-situ Σ).

Counterpart of ``repro/runtime/recalibrate.py``.  When the monitor raises
an alarm the runtime does not redo the cold-start IC → PM flow: drift is
small and continuous, so the current commanded phases are a warm start
for a short alternate ZCD search, requested as an in-situ
``driver.zo_refine`` job.  The Σ attenuators are then refreshed by OSP
(Claim 1) on the read-back bases.  Optionally a few subspace-learning
steps follow: stochastic in-situ descent on Σ with the paper's Eq.-5
structure ``∂L/∂Σ = (Uᵀ r) ⊙ (V* x)``, ``r = Ŵx − Wx``, on the read-back
bases (plain ``torch.einsum``, as the reference computes it outside any
kernel).

The ZO budget can be autotuned from the probe distance at alarm time
(:func:`autotune_zo_steps`).  ``block_range`` scopes every stage to one
tenant's blocks (partial recalibration): co-resident tenants' commanded
state stays bit-identical.  The job's meter snapshot, ZO job, Σ read and
OSP readback go to the driver as one ``run_batch``.

The ZO draws and the Σ descent's probe columns come from a generator on
its own device and move to the driver's (the columns may be injected as
``sl_x``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core import unitary as un
from ..core.mapping import osp
from ..optim.zo import ZOConfig, zo_draws
from .monitor import aggregate_distance, readout_mapping_distance

__all__ = ["RecalConfig", "RecalResult", "recalibrate", "autotune_zo_steps"]


class RecalConfig(NamedTuple):
    zo_steps: int = 400          # warm-start ZCD probe steps per block (max)
    inner: int | None = None     # decay period (default 2T)
    # gentle schedule: drift biases are ~0.01-0.03 rad, so a 0.05-rad
    # first step overshoots and the fast decay then freezes the search
    # above the deployment floor
    delta0: float = 0.02
    decay: float = 1.02
    method: str = "zcd"
    sl_steps: int = 0            # optional in-situ Σ fine-tune steps
    sl_lr: float = 0.2
    sl_probes: int = 8           # probe columns per Σ step
    # -- budget autotuning ---------------------------------------------------
    auto_budget: bool = False    # derive the step budget from d̂ at alarm
    auto_target: float = 0.02    # the recovery target (clear threshold)
    auto_min: int = 64           # floor
    auto_coeff: float = 1.5      # knee slope, in units of 2T per log₂ excess
    auto_quantum: int = 64       # round autotuned budgets up to a multiple


class RecalResult(NamedTuple):
    phi: torch.Tensor            # refreshed commanded phases, (B, 2T)
    sigma: torch.Tensor          # refreshed attenuators, (B, k)
    dist_before: torch.Tensor    # aggregate distance walking in
    dist_after_zo: torch.Tensor  # ... after the warm ZO stage
    dist_after: torch.Tensor     # ... after OSP (+ SL): the recovery point
    ptc_calls: float             # probe budget spent by this job
    zo_steps: int                # ZCD budget actually spent (autotuned)


def autotune_zo_steps(dist: float, cfg: RecalConfig, n_rot: int) -> int:
    """Budget from the probe distance at alarm time: ``auto_coeff``
    alternate sweeps (2T probes each) per log₂ of excess over the target,
    quantized up, floored at ``auto_min`` and capped at ``zo_steps``."""
    ratio = max(float(dist), 0.0) / max(cfg.auto_target, 1e-9)
    if ratio <= 1.0:
        return int(cfg.auto_min)
    steps = int(round(cfg.auto_coeff * 2 * n_rot * math.log2(1.0 + ratio)))
    q = max(1, int(cfg.auto_quantum))
    steps = -(-steps // q) * q
    return int(min(max(steps, cfg.auto_min), cfg.zo_steps))


def recalibrate(gen: torch.Generator | None, driver, w_blocks: torch.Tensor,
                cfg: RecalConfig = RecalConfig(),
                dist_hint: Optional[float] = None,
                block_range: Optional[tuple[int, int]] = None, *,
                sl_x: torch.Tensor | None = None) -> RecalResult:
    """Refresh the driver's commanded ``(phi, sigma)`` against its drifted
    device.

    ``w_blocks``: (B, k, k) mapping targets (the tenant's, with
    ``block_range``).  ``dist_hint``: the monitor's estimate at alarm time
    (else a full readout).  ``sl_x``: the Σ descent's probe columns
    (sl_steps, sl_probes, k), else drawn from ``gen`` like the ZO job's
    per-step draws.
    """
    k = driver.k
    dev = driver.device
    w_blocks = w_blocks.to(dev, torch.float32)
    b = w_blocks.shape[0]
    t = un.mesh_spec(k, driver.kind).n_rot

    # the monitor's estimate at alarm time doubles as dist_before
    if dist_hint is not None:
        dist_before = torch.tensor(float(dist_hint), dtype=torch.float32)
        pre_ops = [("stats", {})]
    else:
        calls0 = driver.stats.total
        dist_before = readout_mapping_distance(driver, w_blocks,
                                               block_range=block_range)
        pre_ops = []

    steps = cfg.zo_steps
    if cfg.auto_budget:
        steps = autotune_zo_steps(float(dist_before), cfg, t)

    # Stage 1: incremental ZO warm-started from the current phases, one
    # driver batch with the meter snapshot, Σ read and the OSP readback
    zo_cfg = ZOConfig(steps=steps, inner=cfg.inner or 2 * t,
                      delta0=cfg.delta0, decay=cfg.decay)
    draws = zo_draws(gen, cfg.method, (b, steps), 2 * t, alt_split=t)
    out = driver.run_batch(pre_ops + [
        ("zo_refine", dict(w_blocks=w_blocks, gen=None, cfg=zo_cfg,
                           method=cfg.method, block_range=block_range,
                           draws=draws.to(dev))),
        ("read_sigma", {}),
        ("readback_bases", dict(block_range=block_range)),
    ])
    if pre_ops:
        calls0 = out[0].total
    res, sigma, (u, v) = out[-3], out[-2], out[-1]

    if block_range is not None:
        sigma = sigma[block_range[0]:block_range[1]]
    dist_after_zo = aggregate_distance((u * sigma[..., None, :]) @ v,
                                       w_blocks)

    # Stage 2: OSP refresh (Claim 1) on the reciprocal readback
    sigma_new = osp(u, v, w_blocks)

    # Stage 3: optional in-situ stochastic Σ descent (Eq.-5 structure),
    # simulated on the read-back bases, metered explicitly
    if cfg.sl_steps > 0:
        if sl_x is None:
            sl_x = torch.randn((cfg.sl_steps, cfg.sl_probes, k),
                               generator=gen, device=gen.device)
        sl_x = sl_x.to(dev, torch.float32)
        for i in range(cfg.sl_steps):
            x = sl_x[i]
            w_hat = (u * sigma_new[..., None, :]) @ v
            r = torch.einsum("bij,nj->bni", w_hat - w_blocks, x)
            ur = torch.einsum("bji,bnj->bni", u, r)               # Uᵀ r
            vx = torch.einsum("bij,nj->bni", v, x)                # V* x
            g = torch.einsum("bni,bni->bi", ur, vx) / cfg.sl_probes
            sigma_new = sigma_new - cfg.sl_lr * g
        driver.charge("probe", float(cfg.sl_steps * cfg.sl_probes * b * 2))

    driver.write_sigma(sigma_new, block_range=block_range)
    dist_after = aggregate_distance(
        (u * sigma_new[..., None, :]) @ v, w_blocks)
    return RecalResult(phi=res.phi, sigma=sigma_new,
                       dist_before=dist_before, dist_after_zo=dist_after_zo,
                       dist_after=dist_after,
                       ptc_calls=float(driver.stats.total - calls0),
                       zo_steps=steps)
