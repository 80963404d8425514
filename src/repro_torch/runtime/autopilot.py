"""Predictive fleet autopilot: forecast-driven maintenance scheduling.

Counterpart of ``repro/runtime/autopilot.py``.  The reactive loop
(``runtime/fleet.py``) waits for hysteretic alarms, by which point served
accuracy has already degraded.  The autopilot uses two forecasts the
router already holds: the OU relaxation law behind
:func:`~repro_torch.runtime.fleet.predicted_distance`, and the per-tenant
EWMA degradation rate the monitor tracks, which pins the tenant's own
stationary level (``d_∞ ≈ d̂ + rate/2θ``).  :func:`predicted_crossing`
inverts that law into ticks until the alarm threshold.

:class:`AutopilotRouter` replaces ``FleetRouter._schedule_repairs`` with

1. a degradation-rate priority queue across chips and co-resident tenants
   (alarmed jobs first, then proactive candidates, fastest-degrading
   first, tie-broken by forecast crossing);
2. proactive partial recalibration of a tenant whose crossing is forecast
   within ``horizon`` ticks, preferring traffic troughs read from the
   :class:`LoadForecast` (a crossing inside the loop's own reaction time
   overrides the trough gate);
3. a PTC-call envelope on proactive work per window (reactive repairs are
   never gated and do not draw it down).

Probe cadence, random draws, the partial-recal machinery and repair-slot
bandwidth are the base router's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from ..hw import DriftConfig
from .fleet import Chip, FleetRouter, RECALIBRATING, Tenant, \
    predicted_distance

__all__ = ["AutopilotConfig", "LoadForecast", "AutopilotRouter",
           "predicted_crossing", "logit_sensitivity"]


@dataclasses.dataclass(frozen=True)
class AutopilotConfig:
    """Policy knobs for the forecast-driven scheduler."""

    horizon: int = 40            # proactive window: schedule a repair if
    #                              the alarm crossing is forecast within
    #                              this many ticks
    trough_load: float = 0.5     # load forecast at/below this fraction of
    #                              capacity counts as a trough (proactive
    #                              jobs prefer to run there)
    budget_calls: float = math.inf  # proactive recal PTC-call envelope
    #                              per window; proactive work defers once
    #                              the rolling window's proactive spend
    #                              exceeds it (reactive spend is exempt
    #                              and does not draw it down)
    budget_window: int = 200     # ticks per budget window
    forecast_period: int = 0     # diurnal period hint for the load
    #                              forecast (0 = pure EWMA, no phase bins)
    forecast_alpha: float = 0.2  # EWMA weight for observed load
    cooldown: int = 0            # min ticks between proactive repairs of
    #                              the same tenant (0 = probe cadence
    #                              already paces them)


def predicted_crossing(distance: float, rate: float, threshold: float,
                       drift: DriftConfig) -> float:
    """Ticks until a tenant's distance is forecast to cross
    ``threshold``, by inverting the OU relaxation law with the
    *empirically calibrated* stationary level.

    The law ``d(Δ) = d_∞ + (d̂ − d_∞)·e^{−2θΔ}`` gives
    ``d' = −2θ(d − d_∞)``, so the measured EWMA rate pins
    ``d_∞ = d̂ + rate/2θ``.  Solving ``d(Δ*) = threshold``::

        Δ* = −ln((threshold − d_∞)/(d̂ − d_∞)) / 2θ

    valid when ``d̂ < threshold < d_∞``.  Limits: for ``rate → ∞`` this
    reduces to the linear extrapolation ``(threshold − d̂)/rate``; for
    ``d_∞ ≤ threshold`` (drift saturates inside tolerance) it returns
    ``inf`` — no forecast crossing, no proactive work.  Already-crossed
    estimates return 0.
    """
    d, r, thr = float(distance), float(rate), float(threshold)
    if d >= thr:
        return 0.0
    if r <= 1e-12:
        return math.inf
    two_theta = max(2.0 * drift.theta, 1e-12)
    d_inf = d + r / two_theta
    if d_inf <= thr:
        return math.inf
    return -math.log((thr - d_inf) / (d - d_inf)) / two_theta


def logit_sensitivity(weights: Sequence) -> list[float]:
    """Per-tenant logit-sensitivity weights from the served layers'
    effective dense weights (arrays or tensors on any device), normalized
    to mean 1.

    For a PTC linear ``y = Wx`` at relative mapping distance ``d``, the
    injected output-energy error is ``≈ d·‖W‖²·E‖x‖²/n``: within one served
    model a layer's leverage on downstream logits scales with its
    Frobenius energy per input column (the prior the ``accuracy_aware``
    policy leans on).
    """
    mats = [torch.as_tensor(w).detach().to("cpu", torch.float64)
            for w in weights]
    energies = [float(torch.sum(w ** 2)) / max(1, w.shape[-1]) for w in mats]
    mean = sum(energies) / len(energies)
    if mean <= 0:
        return [1.0] * len(energies)
    return [e / mean for e in energies]


class LoadForecast:
    """Traffic forecast: periodic (diurnal) profile bins + global EWMA.

    ``observe(load, tick)`` folds one occupancy sample in; ``forecast
    (tick)`` returns the expected load at ``tick``.  With a
    ``period`` hint, each phase bin keeps its own EWMA (the diurnal
    profile), blended toward the global EWMA while a bin is still cold;
    without one, the global EWMA alone is the forecast.  Until any
    sample arrives the forecast is pessimistic (1.0 = full capacity) so
    a cold autopilot never mistakes ignorance for a trough.
    """

    def __init__(self, period: int = 0, alpha: float = 0.2):
        self.period = max(0, int(period))
        self.alpha = float(alpha)
        self.ewma: Optional[float] = None
        self._bins: list[Optional[float]] = [None] * self.period
        self.samples = 0

    def observe(self, load: float, tick: int) -> None:
        load = float(load)
        self.samples += 1
        self.ewma = (load if self.ewma is None
                     else (1.0 - self.alpha) * self.ewma
                     + self.alpha * load)
        if self.period:
            i = tick % self.period
            prev = self._bins[i]
            self._bins[i] = (load if prev is None
                             else (1.0 - self.alpha) * prev
                             + self.alpha * load)

    def forecast(self, tick: int) -> float:
        if self.ewma is None:
            return 1.0
        if self.period:
            b = self._bins[tick % self.period]
            if b is not None:
                return b
        return self.ewma


class AutopilotRouter(FleetRouter):
    """Forecast-driven scheduler on the reactive router's chassis."""

    def __init__(self, chips: list[Chip], cfg, seed: int = 0,
                 recal_enabled: bool = True):
        super().__init__(chips, cfg, seed=seed, recal_enabled=recal_enabled)
        ap = cfg.autopilot if cfg.autopilot is not None else AutopilotConfig()
        self.ap: AutopilotConfig = ap
        self.forecast = LoadForecast(period=ap.forecast_period,
                                     alpha=ap.forecast_alpha)
        self.proactive_recals = 0
        self.deferred_budget = 0     # proactive jobs deferred: envelope
        self.deferred_trough = 0     # proactive jobs deferred: waiting for
        #                              a trough (crossing not yet urgent)
        self.proactive_calls = 0.0   # cumulative proactive recal PTC spend
        self.proactive_windows: list[float] = []  # closed windows' spend
        self._window_start = 0
        self._window_spent = 0.0     # proactive spend, current window
        self._last_proactive: dict[tuple[int, int], int] = {}

    # -- signals -------------------------------------------------------------

    def observe_load(self, load: float) -> None:
        self.forecast.observe(load, self.tick_count)

    def crossing(self, chip: Chip, tenant: Tenant) -> float:
        """Forecast ticks-from-now until this tenant crosses the alarm
        threshold (0 = already past, inf = saturates inside tolerance)."""
        pd = predicted_distance(chip, self.tick_count, self.cfg.drift,
                                tenant)
        return predicted_crossing(pd, tenant.health.rate,
                                  self.cfg.monitor.alarm_threshold,
                                  self.cfg.drift)

    # -- budget window -------------------------------------------------------

    def _roll_budget(self) -> None:
        if self.tick_count - self._window_start >= self.ap.budget_window:
            self.proactive_windows.append(self._window_spent)
            self._window_start = self.tick_count
            self._window_spent = 0.0

    def _finish_recal(self, chip: Chip) -> None:
        proactive = chip.recal_proactive
        before = chip.recal_calls
        super()._finish_recal(chip)
        if proactive:
            spent = chip.recal_calls - before
            self._window_spent += spent
            self.proactive_calls += spent

    # -- the scheduler -------------------------------------------------------

    def _repair_queue(self, pending) -> list[tuple[tuple, Chip, Tenant]]:
        """Build the priority queue over every (chip, tenant) candidate.

        Key (ascending = first served): reactive class before proactive,
        then fastest measured degradation rate, then earliest forecast
        crossing, then (chip, tenant) id for determinism.  Alarmed
        tenants are reactive candidates; unalarmed tenants whose
        crossing is forecast within ``horizon`` are proactive ones.
        """
        queue = []
        for chip, _, _, _ in pending:
            if chip.status == RECALIBRATING or chip.offline:
                continue
            for t in chip.tenants:
                if t.health.alarmed:
                    key = (0, -t.health.rate, 0.0, chip.chip_id,
                           t.tenant_id)
                    queue.append((key, chip, t))
                    continue
                cross = self.crossing(chip, t)
                if cross <= self.ap.horizon:
                    cool = self._last_proactive.get(
                        (chip.chip_id, t.tenant_id))
                    if (cool is not None
                            and self.tick_count - cool < self.ap.cooldown):
                        continue
                    key = (1, -t.health.rate, cross, chip.chip_id,
                           t.tenant_id)
                    queue.append((key, chip, t))
        return sorted(queue, key=lambda e: e[0])

    def _schedule_repairs(self, pending) -> None:
        """Degradation-rate priority queue + trough-gated proactive jobs.

        Repair-slot bandwidth, the one-job-per-chip invariant, and the
        recal machinery are the base router's; only the *choice* of
        which (chip, tenant) gets the next window changes.  A proactive
        job runs when (a) the load forecast says trough, OR (b) its
        crossing is inside the loop's reaction time (waiting would lose
        the race to the alarm anyway) — and never once the window's
        proactive PTC-call spend has reached the envelope.
        """
        if not self.recal_enabled:
            return
        cfg, ap = self.cfg, self.ap
        self._roll_budget()
        occupancy = sum(c.status == RECALIBRATING for c in self.chips)
        free = cfg.max_concurrent_recals - occupancy
        if free <= 0:
            return
        load_now = self.forecast.forecast(self.tick_count)
        in_trough = load_now <= ap.trough_load
        urgent = cfg.recal_latency + cfg.probe_every
        budget_ok = self._window_spent < ap.budget_calls
        taken: set[int] = set()
        for key, chip, tenant in self._repair_queue(pending):
            if free <= 0:
                break
            if chip.chip_id in taken or chip.status == RECALIBRATING:
                continue
            proactive = key[0] == 1
            if proactive:
                if not budget_ok:
                    self.deferred_budget += 1
                    continue
                if not in_trough and key[2] > urgent:
                    self.deferred_trough += 1
                    continue
                self.proactive_recals += 1
                self._last_proactive[(chip.chip_id, tenant.tenant_id)] = \
                    self.tick_count
            self._start_recal(chip, tenant, proactive=proactive)
            taken.add(chip.chip_id)
            free -= 1

    # -- reporting -----------------------------------------------------------

    def report(self) -> dict:
        rep = super().report()
        rep["autopilot"] = dict(
            proactive_recals=self.proactive_recals,
            deferred_budget=self.deferred_budget,
            deferred_trough=self.deferred_trough,
            budget_calls=(None if math.isinf(self.ap.budget_calls)
                          else self.ap.budget_calls),
            budget_window=self.ap.budget_window,
            window_spent=self._window_spent,
            proactive_calls=self.proactive_calls,
            proactive_windows=list(self.proactive_windows),
            horizon=self.ap.horizon, trough_load=self.ap.trough_load,
            load_forecast=(None if self.forecast.ewma is None
                           else self.forecast.forecast(self.tick_count)),
            load_samples=self.forecast.samples)
        return rep
