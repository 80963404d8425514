"""Zeroth-order optimizers for hardware-restricted phase tuning.

Counterpart of ``repro/optim/zo.py``.  IC and PM cannot observe phase
gradients, only end-to-end transfer-matrix losses; they use ZO search:

* ``zcd`` — coordinate descent: draw a coordinate, probe ``L(φ+δφ)`` vs
  ``L(φ)``, step ±δφ (always moves — Algorithm 1); ``alt_split`` probes
  coordinates [0, split) on even steps and [split, n) on odd ones (PM's
  alternate Φ^U / Φ^V schedule).
* ``ztp`` — stochastic three-point: best of {φ, φ+δu, φ−δu}.
* ``zgd`` — antithetic two-point gradient estimate with momentum.

All methods track the BEST solution seen and decay ``δφ ←
max(δφ/β, δφ_l)`` every ``inner`` steps.

Where the reference ``jax.vmap``s one search per block, here every block's
state is one row of a (B, n) tensor and ``loss_fn`` maps (B, n) → (B,);
the ``lax.scan`` over steps is a Python loop.  Per-step random draws come
from ``gen`` or are injected as ``draws``: (B, steps) raw integers for
zcd — the value ``jax.random.randint`` gives at ``zo.py:101`` (a
coordinate in [0, n)) or at ``:106`` (in [0, 2³⁰), folded into the
half-range as there) — or (B, steps, n) normal vectors for ztp / zgd.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["ZOConfig", "ZOResult", "zo_minimize", "zo_draws", "step_draws"]


class ZOConfig(NamedTuple):
    steps: int = 400            # total probe steps
    inner: int = 20             # step-size decay period (Algorithm 1's S)
    delta0: float = 0.1         # initial step δφ_u
    decay: float = 1.05         # β
    delta_min: float = 2 * np.pi / 255.0  # δφ_l (8-bit phase resolution)
    lr0: float = 1.0            # zgd learning rate
    momentum: float = 0.9       # zgd momentum
    record_every: int = 10      # best-loss history stride


class ZOResult(NamedTuple):
    x: torch.Tensor        # best solution recorded, (B, n)
    f: torch.Tensor        # best loss, (B,)
    history: torch.Tensor  # best-loss trace, (B, steps // record_every)


_ALT_RANGE = 1 << 30


def zo_draws(gen: torch.Generator, method: str, shape: tuple[int, ...],
             n: int, alt_split: int | None = None) -> torch.Tensor:
    """Per-step draws of :func:`zo_minimize` for ``shape`` = (..., B,
    steps), made on ``gen``'s device: raw integers for ``zcd`` (a
    coordinate in [0, n), or in [0, 2^30) with ``alt_split``), else (...,
    B, steps, n) normal vectors."""
    if method == "zcd":
        hi = n if alt_split is None else _ALT_RANGE
        return torch.randint(0, hi, shape, generator=gen, device=gen.device)
    return torch.randn(shape + (n,), generator=gen, device=gen.device)


def step_draws(gen: torch.Generator, method: str, b: int, steps: int,
               n: int, alt_split: int | None = None) -> torch.Tensor:
    """The per-step draws :func:`zo_minimize` makes from ``gen`` for a
    search of ``b`` rows, made now and stacked as its ``draws`` ((b,
    steps) integers for ``zcd``, else (b, steps, n) normals): the same
    calls in the same order, so ``draws=step_draws(gen, ...)`` gives the
    bits ``gen=gen`` gives."""
    rows = []
    for _ in range(steps):
        if method != "zcd":
            rows.append(torch.randn((b, n), generator=gen, device=gen.device))
        else:
            hi = n if alt_split is None else _ALT_RANGE
            rows.append(torch.randint(0, hi, (b,), generator=gen,
                                      device=gen.device))
    if not rows:
        return (torch.zeros((b, 0), dtype=torch.int64) if method == "zcd"
                else torch.zeros((b, 0, n)))
    return torch.stack(rows, dim=1)


def zo_minimize(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                x0: torch.Tensor, cfg: ZOConfig, method: str = "zcd",
                alt_split: int | None = None,
                gen: torch.Generator | None = None,
                draws: torch.Tensor | None = None) -> ZOResult:
    """Minimize ``loss_fn`` from ``x0`` (B, n), one search per row."""
    if method not in ("zcd", "ztp", "zgd"):
        raise ValueError(f"unknown ZO method: {method!r}")
    if (gen is None) == (draws is None):
        raise ValueError("zo_minimize: pass exactly one of gen= or draws=")
    b, n = x0.shape
    dev = x0.device
    rows = torch.arange(b, device=dev)

    def draw(step: int) -> torch.Tensor:
        if draws is not None:
            raw = draws[:, step]
            return raw.to(dev) if method == "zcd" else raw.to(dev, x0.dtype)
        if method != "zcd":
            return torch.randn((b, n), generator=gen, device=dev)
        hi = n if alt_split is None else _ALT_RANGE
        return torch.randint(0, hi, (b,), generator=gen, device=dev)

    x = x0
    f = loss_fn(x)
    best_x, best_f = x, f
    delta = float(cfg.delta0)
    m = torch.zeros_like(x0)
    history = []
    for t in range(cfg.steps):
        raw = draw(t)
        if method == "zcd":
            if alt_split is None:
                i = raw
            else:
                lo, hi = (0, alt_split) if t % 2 == 0 else (alt_split, n)
                i = lo + raw % (hi - lo)
            xp = x.clone()
            xp[rows, i] += delta
            f_plus = loss_fn(xp)
            better = f_plus < f
            x_new = x.clone()
            x_new[rows, i] += torch.where(better, delta, -delta).to(x.dtype)
            # the reference evaluates L(x_new) on every step and keeps it
            # only where +δ did not improve
            f = torch.where(better, f_plus, loss_fn(x_new))
            x = x_new
        else:
            u = raw / (torch.linalg.vector_norm(raw, dim=-1,
                                                keepdim=True) + 1e-12)
            if method == "ztp":
                xp, xn = x + delta * u, x - delta * u
                cands_f = torch.stack([f, loss_fn(xp), loss_fn(xn)])
                best = torch.argmin(cands_f, dim=0)
                x = torch.stack([x, xp, xn])[best, rows]
                f = cands_f[best, rows]
            else:
                g = (loss_fn(x + delta * u) - loss_fn(x - delta * u)) \
                    / (2 * delta)
                m = cfg.momentum * m + g[:, None] * u
                x = x - cfg.lr0 * (0.999 ** t) * m
                f = loss_fn(x)
        better = f < best_f
        best_f = torch.where(better, f, best_f)
        best_x = torch.where(better[:, None], x, best_x)
        if (t + 1) % cfg.inner == 0:
            delta = max(delta / cfg.decay, cfg.delta_min)
        if (t + 1) % cfg.record_every == 0:
            history.append(best_f)
    hist = torch.stack(history, dim=-1) if history \
        else x0.new_zeros((b, 0))
    return ZOResult(x=best_x, f=best_f, history=hist)
