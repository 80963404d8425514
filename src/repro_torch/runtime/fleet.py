"""Fleet registry + health-aware router for many virtual chip instances.

Counterpart of ``repro/runtime/fleet.py``.  A deployment is N boards, each
with its own manufacturing realization and drift clock; the router sends
serve traffic around unhealthy devices, and recalibration runs out of band
on a bounded number of repair slots.  Each :class:`Chip` hosts
:class:`Tenant` slots, one mapped layer each on a contiguous block range
of the shared device with its own :class:`HealthState`; probes resolve per
tenant from one shared probe stream, and a repair re-tunes only the
alarmed tenant's blocks (co-tenants stay bit-identical).

Each chip holds a :class:`~repro_torch.hw.PhotonicDriver`; the router
serves through ``driver.forward_layer``, probes through the monitor, lets
time pass with ``driver.advance`` and reads PTC calls off
``driver.stats``.  Per-chip state machine::

    HEALTHY ──tenant probe d̂ > alarm (×consecutive)──▶ DEGRADED
    DEGRADED ──repair slot free──▶ RECALIBRATING   (not routable)
    RECALIBRATING ──job done, tenant probe d̂ < clear──▶ HEALTHY
                 └─ still above clear, or another tenant alarmed ──▶ DEGRADED

Routing policies: ``"drift_aware"`` (the tenant's last estimate
extrapolated along the OU relaxation law, :func:`predicted_distance`),
``"accuracy_aware"`` (forecast excess over the deployment floor weighted
by logit sensitivity) and ``"least_served"``.  The reactive repair policy
is :meth:`FleetRouter._schedule_repairs`; the autopilot overrides it.

Every random draw of the router (probe columns, recal jobs) comes from one
CPU generator seeded by ``seed`` and moves to the chip's device, so one
seed gives one trajectory on the CPU and on the card; a subclass may
override :meth:`FleetRouter._draw_probe` to inject probe columns.
"""

from __future__ import annotations

import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import torch

from ..core.mapping import default_pm_config, parallel_map
from ..core.noise import NoiseModel, DEFAULT_NOISE
from ..core.ptc import blockize
from ..core import unitary as un
from ..hw import make_driver, wire_key, DriftConfig, DEFAULT_DRIFT
from ..optim.zo import zo_draws
from .monitor import (MonitorConfig, HealthState, probe_mapping_distance,
                      score_tenant_probes, update_health, clear_health)
from .recalibrate import RecalConfig, recalibrate

__all__ = ["HEALTHY", "DEGRADED", "RECALIBRATING", "RuntimeConfig",
           "Tenant", "Chip", "FleetRouter", "make_chip", "make_fleet",
           "make_router", "predicted_distance"]

HEALTHY = "healthy"
DEGRADED = "degraded"
RECALIBRATING = "recalibrating"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Static policy knobs for one fleet."""

    k: int = 6
    kind: str = "clements"
    # chips join after burn-in IC: the serving noise frame is post-IC (the
    # static Φ_b is compensated) and drift walks fresh bias on top of it
    noise: NoiseModel = DEFAULT_NOISE.post_ic()
    drift: DriftConfig = DEFAULT_DRIFT
    monitor: MonitorConfig = MonitorConfig()
    recal: RecalConfig = RecalConfig()
    probe_every: int = 10        # ticks between health checks per chip
    recal_latency: int = 4       # ticks a recal job occupies the chip
    max_concurrent_recals: int = 1  # repair-slot bandwidth
    driver_kind: str = "twin"    # make_driver transport
    router_policy: str = "drift_aware"  # | "accuracy_aware" | "least_served"
    deploy_zo: bool = False      # PM stage 2 (alternate ZCD) at deployment
    repair_batch: int = 1        # alarmed tenants re-tuned per repair outage
    autopilot: Optional[object] = None  # AutopilotConfig: make_router then
    #                              builds the AutopilotRouter


@dataclasses.dataclass
class Tenant:
    """One mapped layer resident on a chip: a Σ bank + block range on the
    shared device, with its own health state and counters."""

    tenant_id: int
    m: int
    n: int
    block_range: tuple[int, int]   # (start, stop) into the chip's blocks
    w_blocks: torch.Tensor         # (b_t, k, k) mapping targets
    health: HealthState
    last_probe_tick: int = 0       # when health.distance was last measured
    served: int = 0
    alarms: int = 0
    recals: int = 0
    recal_calls: float = 0.0       # PTC calls spent on this tenant's recals

    @property
    def n_blocks(self) -> int:
        return self.block_range[1] - self.block_range[0]


@dataclasses.dataclass
class Chip:
    """One virtual chip: tenant slots behind a control-plane driver."""

    chip_id: int
    driver: object               # PhotonicDriver (owns phi/sigma/clock/meter)
    tenants: list[Tenant]
    status: str = HEALTHY
    recal_ticks_left: int = 0
    recal_tenant: Optional[int] = None   # tenant the pending job re-tunes
    recal_proactive: bool = False        # pending job was forecast-scheduled
    offline_ticks_left: int = 0  # injected outage: not routable, not
    #                              probeable, repairs stall
    served: int = 0
    alarms: int = 0
    recals: int = 0
    recal_calls: float = 0.0     # PTC calls spent by recal jobs

    @property
    def offline(self) -> bool:
        return self.offline_ticks_left > 0

    @property
    def routable(self) -> bool:
        return self.status != RECALIBRATING and not self.offline

    @property
    def alarmed(self) -> bool:
        return any(t.health.alarmed for t in self.tenants)

    # -- single-tenant views (a one-weight chip has one tenant) --------------

    @property
    def m(self) -> int:
        return self.tenants[0].m

    @property
    def n(self) -> int:
        return self.tenants[0].n

    @property
    def w_blocks(self) -> torch.Tensor:
        if len(self.tenants) == 1:
            return self.tenants[0].w_blocks
        return torch.cat([t.w_blocks for t in self.tenants], dim=0)

    @property
    def health(self) -> HealthState:
        return self.tenants[0].health

    @health.setter
    def health(self, h: HealthState) -> None:
        self.tenants[0].health = h

    @property
    def last_probe_tick(self) -> int:
        return self.tenants[0].last_probe_tick

    @last_probe_tick.setter
    def last_probe_tick(self, tick: int) -> None:
        self.tenants[0].last_probe_tick = tick


def _tenant_layout(weights: Sequence, k: int
                   ) -> list[tuple[int, int, tuple[int, int]]]:
    """(m, n, block_range) per tenant, packed contiguously in order."""
    out = []
    offset = 0
    for w in weights:
        m, n = int(w.shape[0]), int(w.shape[1])
        b = (-(-m // k)) * (-(-n // k))
        out.append((m, n, (offset, offset + b)))
        offset += b
    return out


def make_chip(gen: torch.Generator, chip_id: int, w, cfg: RuntimeConfig,
              driver=None, *, device=None) -> Chip:
    """Deploy weight(s) onto a fresh device.

    ``w`` is one (M, N) weight (a single-tenant chip) or a sequence, one
    mapped layer per tenant packed into contiguous block ranges.  Builds
    the chip's driver on ``device`` (the device realization and the drift
    chain's seed drawn from ``gen``), then PMs each tenant onto its range
    (commanded SVD + OSP; ``cfg.deploy_zo`` adds the alternate ZCD, its
    draws from ``gen``)."""
    weights = list(w) if isinstance(w, (list, tuple)) else [w]
    layout = _tenant_layout(weights, cfg.k)
    total_blocks = layout[-1][2][1]
    single = len(weights) == 1
    if driver is None:
        m0, n0 = layout[0][0], layout[0][1]
        driver = make_driver(cfg.driver_kind, gen, total_blocks, cfg.k,
                             cfg.noise, cfg.kind, m=m0, n=n0,
                             drift=cfg.drift, device=device)
    t_rot = un.mesh_spec(cfg.k, cfg.kind).n_rot
    tenants = []
    for i, (wi, (m, n, rng)) in enumerate(zip(weights, layout)):
        b = rng[1] - rng[0]
        pm_cfg = draws = None
        if cfg.deploy_zo:
            pm_cfg = default_pm_config(t_rot)
            draws = zo_draws(gen, "zcd", (b, pm_cfg.steps), 2 * t_rot,
                             alt_split=t_rot)
        wi = torch.as_tensor(wi, dtype=torch.float32, device=driver.device)
        pm = parallel_map(None, wi, cfg.k, cfg.noise, kind=cfg.kind,
                          cfg=pm_cfg, run_zo=cfg.deploy_zo, driver=driver,
                          block_range=None if single else rng, draws=draws)
        w_blocks = blockize(wi, cfg.k).reshape(b, cfg.k, cfg.k)
        health = HealthState(distance=float(pm.err_osp.mean()))
        tenants.append(Tenant(tenant_id=i, m=m, n=n, block_range=rng,
                              w_blocks=w_blocks, health=health))
    return Chip(chip_id=chip_id, driver=driver, tenants=tenants)


def make_fleet(gen: torch.Generator, n_chips: int, w, cfg: RuntimeConfig,
               *, device=None) -> list[Chip]:
    """N chips serving the same logical weight(s), each with its own
    realization and drift path, drawn from ``gen`` in chip order.

    On a stream transport each chip's server child takes seconds to start
    and to warm up, so without ``deploy_zo`` (no deploy draw between two
    chips' keys) the chips deploy together: each from a generator at the
    state ``gen`` had where one chip after another would have drawn that
    chip's key, and ``gen`` left where one chip after another leaves it.
    If one fails, the others' drivers are closed."""
    if cfg.driver_kind == "twin" or cfg.deploy_zo or n_chips == 1:
        return [make_chip(gen, i, w, cfg, device=device)
                for i in range(n_chips)]
    gens = []
    for _ in range(n_chips):
        g = torch.Generator(gen.device)
        g.set_state(gen.get_state())
        gens.append(g)
        wire_key(gen)                  # the draw make_chip makes from g
    with ThreadPoolExecutor(n_chips) as ex:
        futs = [ex.submit(make_chip, g, i, w, cfg, device=device)
                for i, g in enumerate(gens)]
    chips, err = [], None
    for f in futs:
        try:
            chips.append(f.result())
        except Exception as e:       # close the others, then re-raise
            err = err or e
    if err is not None:
        for c in chips:
            c.driver.close()
        raise err
    return chips


def make_router(chips: list[Chip], cfg: RuntimeConfig, seed: int = 0,
                recal_enabled: bool = True) -> "FleetRouter":
    """The reactive :class:`FleetRouter`, or the forecast-driven
    ``AutopilotRouter`` when ``cfg.autopilot`` is set."""
    if cfg.autopilot is not None:
        from .autopilot import AutopilotRouter
        return AutopilotRouter(chips, cfg, seed=seed,
                               recal_enabled=recal_enabled)
    return FleetRouter(chips, cfg, seed=seed, recal_enabled=recal_enabled)


def predicted_distance(chip: Chip, now: int, drift: DriftConfig,
                       tenant: Optional[Tenant] = None) -> float:
    """Forecast of a tenant's mapping distance at tick ``now`` (the chip's
    first tenant by default): the last estimate relaxed along the OU law
    toward the stationary level ``σ_φ²/2θ`` with rate ``2θ``::

        d(Δ) ≈ d_∞ + (d̂ − d_∞)·exp(−2θΔ),   d_∞ = σ_φ²/(2θ)
    """
    t = tenant if tenant is not None else chip.tenants[0]
    dt = max(0, now - t.last_probe_tick)
    d_inf = drift.sigma_phase ** 2 / (2.0 * drift.theta + 1e-12)
    decay = math.exp(-2.0 * drift.theta * dt)
    return d_inf + (t.health.distance - d_inf) * decay


class FleetRouter:
    """Dispatches serve traffic; drives drift, probes and repair jobs.

    The router owns virtual time: one :meth:`tick` advances every chip's
    clock, runs due health checks and counts repair jobs down.
    RECALIBRATING chips are never dispatched to.
    """

    def __init__(self, chips: list[Chip], cfg: RuntimeConfig,
                 seed: int = 0, recal_enabled: bool = True):
        if not chips:
            raise ValueError("fleet must contain at least one chip")
        self.chips = chips
        self.cfg = cfg
        self.recal_enabled = recal_enabled
        self.tick_count = 0
        self.dropped = 0             # batches with no routable chip
        self.events: list[dict] = []
        self._gen = torch.Generator("cpu").manual_seed(seed)
        # deployment-time floors: "accuracy_aware" ranks by drift-induced
        # excess over them
        self._floor = {c.chip_id: [t.health.distance for t in c.tenants]
                       for c in chips}
        self.sensitivity: Optional[list[float]] = None

    def set_sensitivity(self, weights: Sequence[float]) -> None:
        """Per-tenant logit-sensitivity weights for ``accuracy_aware``."""
        n = len(self.chips[0].tenants)
        if len(weights) != n:
            raise ValueError(f"expected {n} tenant weights, "
                             f"got {len(weights)}")
        self.sensitivity = [float(w) for w in weights]

    def _tenant_weight(self, idx: int) -> float:
        return 1.0 if self.sensitivity is None else self.sensitivity[idx]

    def observe_load(self, load: float) -> None:
        """Load-forecast hook (the autopilot folds it into its forecast)."""

    # -- random draws -------------------------------------------------------

    def _draw_probe(self, chip: Chip) -> torch.Tensor:
        """One health check's probe columns (n_probes, k), drawn from the
        router's CPU generator and moved to the chip's device."""
        x = torch.randn((self.cfg.monitor.n_probes, chip.driver.k),
                        generator=self._gen)
        return x.to(chip.driver.device)

    # -- routing ------------------------------------------------------------

    def dispatch(self, tenant: int = 0) -> Optional[Chip]:
        """A routable chip for ``tenant``'s traffic, HEALTHY first, ranked
        by the configured policy."""
        for pool in (HEALTHY, DEGRADED):
            cands = [c for c in self.chips
                     if c.status == pool and c.routable
                     and tenant < len(c.tenants)]
            if not cands:
                continue
            if self.cfg.router_policy == "drift_aware":
                return min(cands, key=lambda c: (
                    predicted_distance(c, self.tick_count, self.cfg.drift,
                                       c.tenants[tenant]),
                    c.tenants[tenant].served, c.served, c.chip_id))
            if self.cfg.router_policy == "accuracy_aware":
                return min(cands, key=lambda c:
                           self._accuracy_key(c, tenant))
            return min(cands, key=lambda c: (c.tenants[tenant].served,
                                             c.served, c.chip_id))
        return None

    def _accuracy_key(self, c: Chip, tenant: int) -> tuple:
        """Forecast logit infidelity (sensitivity-weighted excess over the
        deployment floor), then the raw forecast (so the policy reduces to
        ``drift_aware`` at σ_drift = 0)."""
        pd = predicted_distance(c, self.tick_count, self.cfg.drift,
                                c.tenants[tenant])
        excess = max(0.0, pd - self._floor[c.chip_id][tenant])
        return (self._tenant_weight(tenant) * excess, pd,
                c.tenants[tenant].served, c.served, c.chip_id)

    def serve(self, x: torch.Tensor, tenant: int = 0
              ) -> tuple[Optional[torch.Tensor], Optional[int]]:
        """Route one batch ``x`` (..., n_t) of ``tenant``'s traffic through
        a chip's realized (drifted) transfer function, scoped to the
        tenant's block range.  Returns (y, chip_id); (None, None) when no
        chip is routable (counted as ``dropped``)."""
        chip = self.dispatch(tenant)
        if chip is None:
            self.dropped += 1
            return None, None
        t = chip.tenants[tenant]
        y = chip.driver.forward_layer(x, block_range=t.block_range,
                                      out_dim=t.m)
        chip.served += 1
        t.served += 1
        return y, chip.chip_id

    def route_pass(self) -> Optional[Chip]:
        """ONE chip for a whole forward pass (every tenant slot on the same
        board): the chip whose worst forecast tenant fidelity is best."""
        for pool in (HEALTHY, DEGRADED):
            cands = [c for c in self.chips
                     if c.status == pool and c.routable]
            if not cands:
                continue
            if self.cfg.router_policy == "drift_aware":
                return min(cands, key=lambda c: (
                    max(predicted_distance(c, self.tick_count,
                                           self.cfg.drift, t)
                        for t in c.tenants),
                    c.served, c.chip_id))
            if self.cfg.router_policy == "accuracy_aware":
                return min(cands, key=self._accuracy_pass_key)
            return min(cands, key=lambda c: (c.served, c.chip_id))
        return None

    def _accuracy_pass_key(self, c: Chip) -> tuple:
        """Whole-pass ``accuracy_aware`` key: the sum over tenants of the
        weighted forecast excess, then the worst raw forecast."""
        now, drift = self.tick_count, self.cfg.drift
        pds = [predicted_distance(c, now, drift, t) for t in c.tenants]
        floors = self._floor[c.chip_id]
        excess = sum(self._tenant_weight(j) * max(0.0, pd - floors[j])
                     for j, pd in enumerate(pds))
        return (excess, max(pds), c.served, c.chip_id)

    def _pass_ops(self, chip: Chip, items) -> list:
        ops = []
        for idx, x in items:
            t = chip.tenants[idx]
            ops.append(("forward_layer", dict(x=x, block_range=t.block_range,
                                              out_dim=t.m)))
        return ops

    def serve_pass(self, chip: Chip, items) -> list:
        """Several tenants' layer products on ``chip`` in one driver batch
        (``items`` = ``[(tenant_idx, x), ...]``)."""
        ys = chip.driver.run_batch(self._pass_ops(chip, items))
        for idx, _ in items:
            chip.tenants[idx].served += 1
        chip.served += len(items)
        return ys

    def serve_pass_async(self, chip: Chip, items):
        """:meth:`serve_pass` issued now, collected through the returned
        future's ``.result()``; counters update at issue."""
        fut = chip.driver.run_batch_async(self._pass_ops(chip, items))
        for idx, _ in items:
            chip.tenants[idx].served += 1
        chip.served += len(items)
        return fut

    # -- the closed loop ----------------------------------------------------

    def tick(self, dt: float = 1.0) -> None:
        """Advance virtual time: every chip's clock runs, due probes fire,
        alarms raise, repair jobs schedule and complete.

        Two phases: the issue phase walks chips in order (clocks advance,
        finished repairs land, due probes go out through
        ``driver.run_batch_async``); the collect phase scores the
        responses in the same order and then schedules repairs against the
        slot occupancy each chip saw in the walk."""
        cfg = self.cfg
        self.tick_count += 1
        in_repair = sum(c.status == RECALIBRATING for c in self.chips)
        probe_due = self.tick_count % cfg.probe_every == 0

        pending = []
        for chip in self.chips:
            chip.driver.advance(dt)

            if chip.offline:
                # the board is unreachable: drift walks, no probe goes
                # out, an in-flight repair stalls until the outage lifts
                chip.offline_ticks_left -= 1
                if not chip.offline:
                    self.events.append(dict(tick=self.tick_count,
                                            event="outage_end",
                                            chip=chip.chip_id))
                continue

            if chip.status == RECALIBRATING:
                chip.recal_ticks_left -= 1
                if chip.recal_ticks_left <= 0:
                    self._finish_recal(chip)
                    in_repair -= 1
                continue

            x = fut = None
            if probe_due:
                x = self._draw_probe(chip)
                fut = chip.driver.run_batch_async(
                    [("forward", dict(x=x, category="probe"))])
            pending.append((chip, in_repair, x, fut))

        for chip, _, x, fut in pending:
            if fut is not None:
                self._score_probe(chip, x, fut.result()[0])
        self._schedule_repairs(pending)

    def _schedule_repairs(self, pending) -> None:
        """Reactive (alarm-driven) repair scheduling, in issue order; the
        worst alarmed tenant wins the chip's repair window."""
        cfg = self.cfg
        scheduled = 0
        for chip, base_repair, _, _ in pending:
            if (chip.alarmed and self.recal_enabled
                    and base_repair + scheduled < cfg.max_concurrent_recals):
                alarmed = [t for t in chip.tenants if t.health.alarmed]
                worst = max(alarmed, key=lambda t: t.health.distance)
                self._start_recal(chip, worst)
                scheduled += 1

    def _start_recal(self, chip: Chip, tenant: Tenant,
                     proactive: bool = False) -> None:
        """Commit one repair window: the chip leaves the routable pool for
        ``cfg.recal_latency`` ticks."""
        chip.status = RECALIBRATING
        chip.recal_tenant = tenant.tenant_id
        chip.recal_proactive = proactive
        chip.recal_ticks_left = self.cfg.recal_latency
        ev = dict(tick=self.tick_count, event="recal_start",
                  chip=chip.chip_id, tenant=tenant.tenant_id)
        if proactive:
            ev["proactive"] = True
        self.events.append(ev)

    def inject_outage(self, chip_id: int, ticks: int) -> None:
        """Fault injection: one chip off the network for ``ticks`` ticks."""
        chip = next(c for c in self.chips if c.chip_id == chip_id)
        chip.offline_ticks_left = max(chip.offline_ticks_left, int(ticks))
        self.events.append(dict(tick=self.tick_count, event="outage",
                                chip=chip_id, ticks=int(ticks)))

    def _score_probe(self, chip: Chip, x: torch.Tensor, y_hat) -> None:
        """Fold one probe response into each tenant's health (one host sync
        per probe: the estimates are read as floats)."""
        cfg = self.cfg
        ests = score_tenant_probes(
            x, y_hat, [(t.block_range, t.w_blocks) for t in chip.tenants])
        for ten, est in zip(chip.tenants, ests):
            was_alarmed = ten.health.alarmed
            ten.health = update_health(ten.health, float(est), cfg.monitor,
                                       dt=self.tick_count
                                       - ten.last_probe_tick)
            ten.last_probe_tick = self.tick_count
            if ten.health.alarmed and not was_alarmed:
                ten.alarms += 1
                chip.alarms += 1
                chip.status = DEGRADED
                self.events.append(dict(tick=self.tick_count, event="alarm",
                                        chip=chip.chip_id,
                                        tenant=ten.tenant_id,
                                        distance=ten.health.distance))

    def _finish_recal(self, chip: Chip) -> None:
        """The repair job lands: partial recalibration of the scheduled
        tenant (plus up to ``repair_batch − 1`` other alarmed tenants,
        worst first) against the chip's current drifted state, then a
        scoped re-probe to clear."""
        cfg = self.cfg
        first = chip.tenants[chip.recal_tenant or 0]
        others = sorted((t for t in chip.tenants
                         if t.health.alarmed and t is not first),
                        key=lambda t: -t.health.distance)
        for ten in (first, *others[:max(0, cfg.repair_batch - 1)]):
            res = recalibrate(self._gen, chip.driver, ten.w_blocks,
                              cfg.recal, dist_hint=ten.health.distance,
                              block_range=ten.block_range)
            ten.recals += 1
            chip.recals += 1
            ten.recal_calls += res.ptc_calls
            chip.recal_calls += res.ptc_calls
            est = probe_mapping_distance(None, chip.driver, ten.w_blocks,
                                         cfg.monitor.n_probes,
                                         block_range=ten.block_range,
                                         x=self._draw_probe(chip))
            ten.health = clear_health(ten.health, float(est), cfg.monitor)
            ten.last_probe_tick = self.tick_count
            ev = dict(
                tick=self.tick_count, event="recal_done", chip=chip.chip_id,
                tenant=ten.tenant_id,
                dist_before=float(res.dist_before),
                dist_after=float(res.dist_after), zo_steps=res.zo_steps,
                status=RECALIBRATING)
            if chip.recal_proactive:
                ev["proactive"] = True
            self.events.append(ev)
        chip.status = HEALTHY if not chip.alarmed else DEGRADED
        chip.recal_tenant = None
        chip.recal_proactive = False
        self.events[-1]["status"] = chip.status

    # -- reporting ----------------------------------------------------------

    def true_distances(self) -> list[float]:
        """Exact per-chip mapping distances (all tenants aggregated): a
        twin-only diagnostic through ``driver.unsafe_twin()``."""
        return [c.driver.unsafe_twin().true_mapping_distance(c.w_blocks)  # repro: noqa[RPL102]
                for c in self.chips]

    def true_tenant_distances(self) -> list[list[float]]:
        """Exact per-(chip, tenant) mapping distances (twin-only)."""
        return [[c.driver.unsafe_twin().true_mapping_distance(  # repro: noqa[RPL102]
                    t.w_blocks, t.block_range)
                 for t in c.tenants] for c in self.chips]

    def report(self) -> dict:
        chips = []
        for c in self.chips:
            s = c.driver.stats
            # everything metered that is neither serve traffic nor a recal
            # job's delta is monitor probing (incl. the PM readout)
            chips.append(dict(
                chip=c.chip_id, status=c.status, offline=c.offline,
                served=c.served,
                distance=max(t.health.distance for t in c.tenants),
                alarms=c.alarms, recals=c.recals,
                probe_ptc_calls=s.total - s.serve - c.recal_calls,
                recal_ptc_calls=c.recal_calls,
                serve_ptc_calls=s.serve,
                ptc_calls=s.as_dict(),
                tenants=[dict(tenant=t.tenant_id,
                              block_range=list(t.block_range),
                              m=t.m, n=t.n, served=t.served,
                              distance=t.health.distance,
                              alarmed=t.health.alarmed,
                              alarms=t.alarms, recals=t.recals,
                              recal_ptc_calls=t.recal_calls)
                         for t in c.tenants]))
        return dict(ticks=self.tick_count, dropped=self.dropped,
                    chips=chips, events=self.events)

    def close(self) -> None:
        """Release every chip's driver transport, all of them even if one
        raises, together (a server child takes seconds to exit); failures
        are re-raised together."""
        def close_one(c: Chip) -> str | None:
            try:
                c.driver.close()
            except Exception as e:  # noqa: BLE001 - collect, close the rest
                return f"chip {c.chip_id}: {e!r}"
            return None

        with ThreadPoolExecutor(max(1, len(self.chips))) as ex:
            errors = [e for e in ex.map(close_one, self.chips) if e]
        if errors:
            raise RuntimeError("fleet close failed for " + "; ".join(errors))
