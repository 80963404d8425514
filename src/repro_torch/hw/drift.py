"""Time-dependent device drift: seeded Ornstein–Uhlenbeck phase walk.

Counterpart of ``repro/hw/drift.py``.  A photonic mesh drifts: thermal
gradients and aging move the phase biases, which is why in-situ
re-optimization matters (L2ight §3.2).  This module layers a time axis on
the static :class:`~repro_torch.core.noise.PhaseNoise` of a
:class:`~repro_torch.hw.device.DeviceRealization`:

* the *anchor* is the manufacturing realization; drift reverts toward it
  (thermal fluctuation) plus an optional deterministic ramp (aging);
* :func:`advance` is one Euler–Maruyama step of the OU SDE

      dφ_b = θ (φ_anchor + a·t − φ_b) dt + σ_φ √dt · dW

  on the phase biases of both meshes (and a slower OU walk on Γ).

Only ``Φ_b`` and ``Γ`` move; the sign diagonals ``d_u`` / ``d_v`` are
topological and fixed.  The normal draws come from a generator (drawn on
its device, then moved to the realization's) or are injected as ``eps``,
so one seed gives one trajectory on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.noise import PhaseNoise
from .device import DeviceRealization  # repro: noqa[RPL103]

__all__ = ["DriftConfig", "DriftState", "init_drift", "advance",
           "bias_deviation", "DEFAULT_DRIFT"]


class DriftConfig(NamedTuple):
    """OU drift parameters (units: radians and virtual ticks)."""

    sigma_phase: float = 0.004   # diffusion on the phase biases, rad/√tick
    theta: float = 0.01          # mean reversion rate toward the anchor
    sigma_gamma: float = 0.0     # diffusion on Γ (slow; off by default)
    aging: float = 0.0           # deterministic anchor ramp, rad/tick


DEFAULT_DRIFT = DriftConfig()


class DriftState(NamedTuple):
    """A realization with a time axis: ``anchor`` is what the OU process
    reverts to, ``dev`` the current (drifted) realization."""

    anchor: DeviceRealization  # repro: noqa[RPL103]
    dev: DeviceRealization  # repro: noqa[RPL103]
    t: float                     # virtual time (ticks)


def init_drift(dev: DeviceRealization) -> DriftState:  # repro: noqa[RPL103]
    """Start the clock at t = 0 with the freshly sampled realization."""
    return DriftState(anchor=dev, dev=dev, t=0.0)  # repro: noqa[RPL103]


def _ou_step(x, x_anchor, theta, sigma, dt, eps):
    return x + theta * (x_anchor - x) * dt + sigma * math.sqrt(dt) * eps


def advance(state: DriftState, dt: float,  # repro: noqa[RPL103]
            gen: torch.Generator | None = None,
            cfg: DriftConfig = DEFAULT_DRIFT, *,
            eps: tuple | None = None) -> DriftState:  # repro: noqa[RPL103]
    """One drift step of size ``dt``.

    The four normal draws, in the reference's split order (bias_u, bias_v,
    gamma_u, gamma_v), come from ``gen`` or are given as ``eps``.  A term
    whose diffusion is zero is not drawn: with ``cfg.sigma_gamma == 0`` the
    two Γ draws are skipped (``eps`` may carry two tensors), and with both
    σ zero no draw is made at all (``eps`` is not read).  The skipped terms
    are exactly zero, so the bits are those of the draws made; with
    ``sigma_gamma != 0`` all four are drawn, in that order, whatever
    ``sigma_phase`` is.
    """
    anchor, dev = state.anchor, state.dev
    shape = dev.noise_u.bias.shape
    if cfg.sigma_gamma != 0.0:
        n_draws = 4
    else:
        n_draws = 2 if cfg.sigma_phase != 0.0 else 0
    if eps is None and n_draws:
        if gen is None:
            raise ValueError("advance: pass gen= or eps=")
        eps = [torch.randn(shape, generator=gen, device=gen.device)
               for _ in range(n_draws)]
    eps = [torch.as_tensor(e, dtype=torch.float32).to(dev.noise_u.bias.device)
           for e in (eps or [])[:n_draws]]
    dt = float(dt)
    ramp = cfg.aging * state.t
    if n_draws:
        bias_u = _ou_step(dev.noise_u.bias, anchor.noise_u.bias + ramp,
                          cfg.theta, cfg.sigma_phase, dt, eps[0])
        bias_v = _ou_step(dev.noise_v.bias, anchor.noise_v.bias + ramp,
                          cfg.theta, cfg.sigma_phase, dt, eps[1])
    else:
        bias_u = dev.noise_u.bias + cfg.theta * (
            anchor.noise_u.bias + ramp - dev.noise_u.bias) * dt
        bias_v = dev.noise_v.bias + cfg.theta * (
            anchor.noise_v.bias + ramp - dev.noise_v.bias) * dt
    if n_draws == 4:
        gamma_u = _ou_step(dev.noise_u.gamma, anchor.noise_u.gamma,
                           cfg.theta, cfg.sigma_gamma, dt, eps[2])
        gamma_v = _ou_step(dev.noise_v.gamma, anchor.noise_v.gamma,
                           cfg.theta, cfg.sigma_gamma, dt, eps[3])
    else:
        gamma_u = dev.noise_u.gamma + cfg.theta * (
            anchor.noise_u.gamma - dev.noise_u.gamma) * dt
        gamma_v = dev.noise_v.gamma + cfg.theta * (
            anchor.noise_v.gamma - dev.noise_v.gamma) * dt
    new_dev = DeviceRealization(  # repro: noqa[RPL103]
        noise_u=PhaseNoise(gamma=gamma_u, bias=bias_u),
        noise_v=PhaseNoise(gamma=gamma_v, bias=bias_v),
        d_u=dev.d_u, d_v=dev.d_v)
    return DriftState(anchor=anchor, dev=new_dev, t=state.t + dt)  # repro: noqa[RPL103]


def bias_deviation(state: DriftState) -> torch.Tensor:  # repro: noqa[RPL103]
    """RMS phase-bias deviation from the anchor (radians)."""
    du = state.dev.noise_u.bias - state.anchor.noise_u.bias
    dv = state.dev.noise_v.bias - state.anchor.noise_v.bias
    return torch.sqrt(torch.mean(torch.cat([du.reshape(-1),
                                            dv.reshape(-1)]) ** 2))
