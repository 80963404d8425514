"""Health probes + alarm logic for a deployed chip.

Counterpart of ``repro/runtime/monitor.py``.  On chip the full realized
transfer matrix is not observable for free (B·k PTC calls), so the monitor
estimates mapping fidelity stochastically from a few forward probes:
Gaussian columns streamed through the driver, compared electronically
against the target response,

    d̂ = Σ_blocks ‖Ŵ x − W x‖² / Σ_blocks ‖W x‖²,

an unbiased estimator of the aggregate ``mapping.matrix_distance`` (the
full-readout variant is :func:`readout_mapping_distance`).  On a
multi-tenant chip one probe stream is scored per tenant
(:func:`probe_tenant_distances`), each tenant keeping its own hysteretic
alarm: ``consecutive`` estimates above ``alarm_threshold`` raise it, and
it clears only below the lower ``clear_threshold``.

The probe columns are drawn from a generator on its own device (a CPU
generator gives the same columns on the CPU and on the card) and moved to
the driver's, or are given as ``x`` (``cols`` for the identity probe).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.calibration import identity_mse
from ..hw.driver import readout_blocks

__all__ = ["MonitorConfig", "HealthState", "aggregate_distance",
           "probe_mapping_distance", "probe_tenant_distances",
           "score_tenant_probes", "readout_mapping_distance",
           "probe_identity_distance", "update_health", "clear_health"]


class MonitorConfig(NamedTuple):
    n_probes: int = 6            # probe columns per health check
    alarm_threshold: float = 0.05  # d̂ above this (repeatedly) raises alarm
    clear_threshold: float = 0.02  # recal must restore d̂ below this
    consecutive: int = 2         # strikes before the alarm fires
    rate_alpha: float = 0.5      # EWMA weight for the degradation-rate track


@dataclasses.dataclass
class HealthState:
    """Per-tenant monitor state (the fleet registry owns it)."""

    distance: float = 0.0        # latest probe estimate d̂
    strikes: int = 0             # consecutive probes above alarm_threshold
    alarmed: bool = False
    probes: int = 0              # health checks performed
    rate: float = 0.0            # EWMA of Δd̂/Δt between probes (0 until
    #                              two probes have landed)


def _normal(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """Standard normals drawn on ``gen``'s device, then moved to ``device``."""
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


def aggregate_distance(w_hat: torch.Tensor,
                       w_blocks: torch.Tensor) -> torch.Tensor:
    """Σ_blocks‖Ŵ−W‖² / Σ_blocks‖W‖² over a chip's block batch."""
    num = torch.sum((w_hat - w_blocks) ** 2, dim=(-2, -1))
    den = torch.sum(w_blocks ** 2, dim=(-2, -1)) + 1e-12
    return torch.sum(num) / torch.sum(den)


def probe_mapping_distance(gen: torch.Generator | None, driver,
                           w_blocks: torch.Tensor, n_probes: int,
                           block_range: tuple[int, int] | None = None, *,
                           x: torch.Tensor | None = None) -> torch.Tensor:
    """Estimate of the aggregate mapping distance from ``n_probes``
    Gaussian forward probes shared across blocks (drawn from ``gen``, or
    ``x``); ``block_range`` scopes it to one tenant (``w_blocks`` then
    carries that tenant's targets)."""
    k = w_blocks.shape[-1]
    if x is None:
        x = _normal(gen, (n_probes, k), driver.device)
    x = x.to(driver.device, torch.float32)
    y_hat = driver.forward(x, category="probe",
                           block_range=block_range)      # (B, n, k)
    y_ref = torch.einsum("bij,nj->bni", w_blocks, x)
    num = torch.sum((y_hat - y_ref) ** 2)
    den = torch.sum(y_ref ** 2) + 1e-12
    return num / den


def probe_tenant_distances(gen: torch.Generator | None, driver,
                           tenants: "list[tuple[tuple[int, int], torch.Tensor]]",
                           n_probes: int, *,
                           x: torch.Tensor | None = None
                           ) -> list[torch.Tensor]:
    """Per-tenant estimates from ONE shared probe stream through the whole
    chip (B·n PTC calls); ``tenants`` holds ``(block_range, w_blocks)``."""
    if x is None:
        x = _normal(gen, (n_probes, driver.k), driver.device)
    x = x.to(driver.device, torch.float32)
    y_hat = driver.forward(x, category="probe")            # (B, n, k)
    return score_tenant_probes(x, y_hat, tenants)


def score_tenant_probes(x: torch.Tensor, y_hat: torch.Tensor,
                        tenants: "list[tuple[tuple[int, int], torch.Tensor]]"
                        ) -> list[torch.Tensor]:
    """Score one shared probe response per tenant: ``x`` (n, k) produced
    ``y_hat`` (B, n, k); each tenant compares its block slice with its own
    targets."""
    out = []
    for (start, stop), w_blocks in tenants:
        y_ref = torch.einsum("bij,nj->bni", w_blocks, x)
        num = torch.sum((y_hat[start:stop] - y_ref) ** 2)
        out.append(num / (torch.sum(y_ref ** 2) + 1e-12))
    return out


def readout_mapping_distance(driver, w_blocks: torch.Tensor,
                             block_range: tuple[int, int] | None = None
                             ) -> torch.Tensor:
    """Exact aggregate distance from a full Ŵ readout: k unit-vector probe
    columns per block (observability-legal, B·k calls)."""
    return aggregate_distance(readout_blocks(driver,
                                             block_range=block_range),
                              w_blocks)


def probe_identity_distance(gen: torch.Generator | None, driver,
                            n_probes: int, *,
                            cols: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Identity-state health: read back the realized U / V* and score
    ``n_probes`` random basis columns (drawn from ``gen`` without
    replacement, or ``cols``) against Ĩ's columns, sign-agnostic.  With
    ``n_probes >= k`` this is ``identity_mse`` over both meshes."""
    k = driver.k
    if n_probes >= k:
        u, v = driver.readback_bases()
        return (torch.mean(identity_mse(u))
                + torch.mean(identity_mse(v))) / 2.0
    if cols is None:
        cols = torch.randperm(k, generator=gen,
                              device=gen.device)[:n_probes]
    cols = torch.as_tensor(cols, dtype=torch.long).cpu()
    u, v = driver.readback_bases(cols=cols)   # partial: 2·B·n_probes calls
    eye = torch.eye(k, device=u.device)[:, cols.to(u.device)]
    err_u = torch.mean((torch.abs(u) - eye) ** 2)
    err_v = torch.mean((torch.abs(v) - eye) ** 2)
    return (err_u + err_v) / 2.0


def update_health(h: HealthState, estimate: float,
                  cfg: MonitorConfig, dt: float = 0.0) -> HealthState:
    """Fold one probe estimate into the alarm state (hysteretic).

    ``dt`` (ticks since this tenant's previous probe), when positive,
    folds the observed growth into the EWMA degradation rate; the alarm
    decision does not depend on it."""
    est = float(estimate)
    strikes = h.strikes + 1 if est > cfg.alarm_threshold else 0
    alarmed = h.alarmed or strikes >= cfg.consecutive
    rate = h.rate
    if dt > 0:
        obs = (est - h.distance) / float(dt)
        a = cfg.rate_alpha
        rate = obs if h.probes == 0 else (1.0 - a) * h.rate + a * obs
    return HealthState(distance=est, strikes=strikes, alarmed=alarmed,
                       probes=h.probes + 1, rate=rate)


def clear_health(h: HealthState, estimate: float,
                 cfg: MonitorConfig) -> HealthState:
    """Post-recalibration check: clear the alarm only below the lower
    threshold; the degradation-rate track resets."""
    est = float(estimate)
    ok = est < cfg.clear_threshold
    return HealthState(distance=est, strikes=0 if ok else h.strikes,
                       alarmed=not ok if h.alarmed else False,
                       probes=h.probes + 1, rate=0.0)
