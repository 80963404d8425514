"""Hardware-in-the-loop serving: LM logits through routed chips' realized
transfer (PyTorch port).

Counterpart of ``repro/runtime/hw_serve.py``.  The served model's own PTC
layers execute on the (drifting) photonic fleet, so the closed
drift → alarm → recalibrate loop protects task accuracy, not only the
mapping distance.

* **One tenant per PTC layer.**  :func:`record_ptc_layers` runs one
  digital decode step under a recording
  :func:`~repro_torch.models.layers.ptc_execution` hook and lists every
  named PTC linear in call order (``p0.s0.attn.wq`` …) with its effective
  dense weight ``W = U·diag(Σ)·V*`` cropped to the call's ``(m, n)``.
  :class:`HwServePlane` deploys that list onto each chip
  (``runtime.fleet.make_fleet``): layer *j* is tenant *j*, with its own
  block range, Σ bank, health and partial recalibration.
* **Whole-pass routing.**  Each decode step goes to one chip
  (``FleetRouter.route_pass``); drift advances between steps, probes and
  repairs run out of band.  With no routable chip the step is served
  from the deployment-time shadow transfer and counted in
  ``dropped_passes``.
* **Batched execution.**  Sibling projections that read the same
  activations (``wq``/``wk``/``wv``; cross-attention's ``wk``/``wv``;
  ``gate``/``up``) ship as one driver batch (``FleetRouter.serve_pass``).
* **Shadow twin.**  At deployment the plane reads each tenant's realized
  transfer back through the driver (commanded Σ and one ``run_batch`` of
  ``readback_bases``) and keeps the dense ``Ŵ_j``; ``mode="shadow"``
  serves from these digitally.  At σ_drift = 0 the routed and shadow
  paths apply the same transfer, so greedy decode is token-identical.

Activations stay on their device: the sibling cache compares tensors
with ``torch.equal`` and the wide prefill frames are compacted with a
boolean mask on the device.  ``chips=`` builds a plane over an already
deployed fleet (one carried across from the reference with
:func:`repro_torch.convert.fleet`, or the fleet of another plane), so two
planes can serve from one realization.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.ptc import PTCParams, compose_weight, unblockize
from .fleet import RuntimeConfig, make_fleet, make_router

__all__ = ["PTCLayerSpec", "record_ptc_layers", "HwServePlane"]


@dataclasses.dataclass
class PTCLayerSpec:
    """One PTC linear of the served model = one fleet tenant."""

    index: int                 # tenant index (call order within a step)
    name: str                  # qualified scope name, e.g. "p0.s0.attn.wq"
    m: int                     # output dim the call site consumes
    n: int                     # input dim the call site supplies
    w: torch.Tensor            # effective dense weight (m, n), float32
    group: Optional[str] = None   # sibling group sharing one input


def _effective_weight(p: dict, x: torch.Tensor, d_out: int | None
                      ) -> tuple[int, int, torch.Tensor]:
    """(m, n, W) for a factored PTC param dict at one call site: the
    composed ``U·diag(Σ)·V*`` blocks (Σ cast to the bases' dtype, as
    ``apply_ptc_linear`` casts it), cropped to the call's output dim and
    the un-padded input dim, in float32 on the parameters' device."""
    params = PTCParams(u=p["u"], s=p["s"].to(p["u"].dtype), v=p["v"])
    w_full = unblockize(compose_weight(params))
    n = int(x.shape[-1])
    m = int(d_out) if d_out is not None else int(w_full.shape[0])
    return m, n, w_full[:m, :n].float()


def _sibling_group(name: str) -> Optional[str]:
    """Sibling-group id for layers that read the same activations:
    self-attention's q/k/v and the MLP's gate/up; in cross-attention only
    k/v (``wq`` reads the decoder state, ``wk``/``wv`` the encoder or
    image stream)."""
    scope, _, leaf = name.rpartition(".")
    cross = scope.endswith(".cross")
    if leaf in ("wq", "wk", "wv") and not cross:
        return f"{scope}.qkv"
    if leaf in ("wk", "wv") and cross:
        return f"{scope}.kv"
    if leaf in ("gate", "up"):
        return f"{scope}.gateup"
    return None


def record_ptc_layers(serve_step, params, cache, batch) -> list[PTCLayerSpec]:
    """The decode path's PTC layers, from ONE digital step run under a
    recording hook (``cache`` is written by the step: pass a throwaway
    one).  Call order is the port's Python loop over periods, so the
    indices double as tenant indices."""
    from ..models.layers import ptc_execution

    recorded: list[PTCLayerSpec] = []
    seen: set[str] = set()

    def recorder(name, p, x, cfg, d_out):
        if name in seen:               # decode calls each layer once a step
            raise RuntimeError(
                f"PTC layer {name!r} executed twice in one decode step — "
                f"layer names must be unique for tenant placement")
        seen.add(name)
        m, n, w = _effective_weight(p, x, d_out)
        recorded.append(PTCLayerSpec(index=len(recorded), name=name,
                                     m=m, n=n, w=w,
                                     group=_sibling_group(name)))
        return None                    # stay digital: this is a dry pass

    with ptc_execution(recorder), torch.no_grad():
        serve_step(params, cache, batch)
    if not recorded:
        raise ValueError(
            "served model exposes no named PTC layers on its decode path "
            "(dense mode, or an un-scoped architecture)")
    return recorded


class HwServePlane:
    """The serving-side execution plane: model PTC layers on fleet chips.

    Install :attr:`hook` with ``models.layers.ptc_execution`` around the
    decode loop and wrap each step in :meth:`step` (``launch.steps.
    greedy_decode(layer_exec=...)`` and the gateway do both).  ``mode``:

    * ``"route"``  — layer products run on the routed chip's realized
      (drifted) transfer through ``driver.forward_layer``;
    * ``"shadow"`` — same deployment, products apply the deployment-time
      readback ``Ŵ_j`` digitally.

    ``gen`` draws the fleet (``make_fleet``: realizations and drift chains)
    on ``device`` (default: the layers' weights' device); ``chips`` instead
    serves an already deployed fleet, whose first chip the shadow is read
    from.
    """

    def __init__(self, gen: torch.Generator | None,
                 layers: Sequence[PTCLayerSpec], cfg: RuntimeConfig,
                 n_chips: int, *, mode: str = "route", seed: int = 0,
                 recal_enabled: bool = True, chips=None, device=None):
        if mode not in ("route", "shadow"):
            raise ValueError(f"unknown hw serve mode: {mode!r}")
        self.mode = mode
        self.layers = list(layers)
        self._by_name = {s.name: s for s in self.layers}
        self._groups: dict[str, list[PTCLayerSpec]] = {}
        for s in self.layers:
            if s.group is not None:
                self._groups.setdefault(s.group, []).append(s)
        if chips is None:
            if device is None:
                device = self.layers[0].w.device
            chips = make_fleet(gen, n_chips, [s.w for s in self.layers], cfg,
                               device=device)
        elif len(chips[0].tenants) != len(self.layers):
            raise ValueError(f"fleet hosts {len(chips[0].tenants)} tenants "
                             f"a chip, the model has {len(self.layers)} "
                             f"PTC layers")
        # cfg.autopilot selects the forecast-driven AutopilotRouter
        self.router = make_router(list(chips), cfg, seed=seed,
                                  recal_enabled=recal_enabled)
        if cfg.router_policy == "accuracy_aware":
            from .autopilot import logit_sensitivity
            self.router.set_sensitivity(
                logit_sensitivity([s.w for s in self.layers]))
        # deployment-time shadow: the first chip's realized transfer, read
        # back through the driver — one commanded-Σ read and ONE batch of
        # per-tenant basis readbacks
        drv = self.router.chips[0].driver
        sigma = drv.read_sigma()
        tenants = self.router.chips[0].tenants
        bases = drv.run_batch([("readback_bases",
                                dict(block_range=t.block_range))
                               for t in tenants])
        self._shadow = [
            self._assemble_transfer(spec, u, v,
                                    sigma[t.block_range[0]:t.block_range[1]],
                                    drv.k)
            for spec, t, (u, v) in zip(self.layers, tenants, bases)]
        # per-step state
        self._chip = None
        self._valid: Optional[torch.Tensor] = None
        self._group_cache: dict[tuple[str, str],
                                tuple[torch.Tensor, torch.Tensor]] = {}
        self.steps = 0
        self.frames = 0            # driver round-trips spent on layer math
        self.frame_cols = 0        # Σ activation columns shipped in frames
        self.hw_calls = 0          # layer products served by a chip
        self.shadow_calls = 0      # layer products served by the shadow
        self.dropped_passes = 0    # steps with no routable chip

    @staticmethod
    def _assemble_transfer(spec: PTCLayerSpec, u: torch.Tensor,
                           v: torch.Tensor, sigma: torch.Tensor,
                           k: int) -> torch.Tensor:
        """Dense realized ``Ŵ`` of one tenant: basis readback × commanded
        Σ, assembled and cropped like the digital weight."""
        wb = (u * sigma[:, None, :]) @ v                      # (b, k, k)
        p = -(-spec.m // k)
        q = wb.shape[0] // p
        dense = unblockize(wb.reshape(p, q, k, k))
        return dense[:spec.m, :spec.n].float()

    def observe_load(self, load: float) -> None:
        """Forward the gateway's occupancy signal (active slots plus queue
        depth, over slot capacity) to the router's load forecast."""
        self.router.observe_load(load)

    # -- decode-loop surface -------------------------------------------------

    @contextlib.contextmanager
    def step(self, i: int, valid=None):
        """One decode step: route the whole pass to one chip, serve it,
        then let virtual time pass (``router.tick()``).  With no routable
        chip the step's layers are served from the shadow transfer and the
        pass counts as dropped.

        ``valid`` (chunked prefill): a (B, C) bool mask of the real
        activation columns in this step's (B, C, d) wide frames; the hook
        ships only those columns and zero-fills the padding columns of the
        result."""
        self._group_cache.clear()
        self._chip = None
        self._valid = (torch.as_tensor(np.asarray(valid, bool))
                       if valid is not None else None)
        if self.mode == "route":
            self._chip = self.router.route_pass()
            if self._chip is None:
                self.dropped_passes += 1
        try:
            yield
        finally:
            self._group_cache.clear()
            self._chip = None
            self._valid = None
            self.router.tick()
            self.steps += 1

    def hook(self, name: str, p, x: torch.Tensor, cfg, d_out):
        """``models.layers.ptc_execution`` hook: one PTC layer on the
        plane.  Unknown names stay digital (None)."""
        spec = self._by_name.get(name)
        if spec is None:
            return None
        if self._chip is None:         # shadow mode, or no routable chip
            self.shadow_calls += 1
            return (x.float() @ self._shadow[spec.index].T).to(x.dtype)
        if spec.group is not None:
            hit = self._group_cache.pop((spec.group, name), None)
            if hit is not None:
                x_ref, y = hit
                if torch.equal(x_ref, x):
                    return y
                # a sibling result computed on other activations: drop the
                # whole group, execute singly
                for s in self._groups[spec.group]:
                    self._group_cache.pop((spec.group, s.name), None)
        members = [spec]
        if spec.group is not None and not any(
                (spec.group, s.name) in self._group_cache
                for s in self._groups[spec.group]):
            members = self._groups[spec.group]
        xs, mask = x, None
        if (self._valid is not None and x.dim() == 3
                and tuple(x.shape[:2]) == tuple(self._valid.shape)):
            # wide prefill frame: ship only the real activation columns
            mask = self._valid.reshape(-1).to(x.device)
            xs = x.reshape(-1, x.shape[-1])[mask]
        ys = self.router.serve_pass(self._chip,
                                    [(s.index, xs) for s in members])
        self.frames += 1
        self.frame_cols += int(np.prod(xs.shape[:-1]))
        self.hw_calls += len(members)
        out = None
        for s, y in zip(members, ys):
            y = y.to(x.dtype)
            if mask is not None:
                full = y.new_zeros((mask.numel(), y.shape[-1]))
                full[mask] = y
                y = full.reshape(x.shape[0], x.shape[1], y.shape[-1])
            if s.name == name:
                out = y
            else:
                self._group_cache[(spec.group, s.name)] = (x, y)
        return out

    # -- reporting / lifecycle -----------------------------------------------

    def report(self) -> dict:
        rep = self.router.report()
        rep["hw"] = dict(
            mode=self.mode,
            layers=[dict(tenant=s.index, name=s.name, m=s.m, n=s.n,
                         group=s.group) for s in self.layers],
            steps=self.steps, frames=self.frames,
            frames_per_step=self.frames / max(1, self.steps),
            frame_cols=self.frame_cols,
            cols_per_frame=self.frame_cols / max(1, self.frames),
            hw_calls=self.hw_calls, shadow_calls=self.shadow_calls,
            dropped_passes=self.dropped_passes)
        return rep

    def close(self) -> None:
        self.router.close()
