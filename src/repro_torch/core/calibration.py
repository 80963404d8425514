"""Identity Calibration (IC): variation-agnostic circuit state preparation.

Counterpart of ``repro/core/calibration.py``.  After manufacturing the
mesh state is unknown (Φ_b ~ U(0,2π), Γ, Ω); the solvable surrogate is
Eq. (2)  ``min_Φ ‖ U(Φ^U) Σ_cal V*(Φ^V) Σ_cal⁻¹ − I ‖²``  whose optimum is
a sign-flip identity.  Pure control-plane code: it picks the Σ_cal
schedule and the ZO budget, then requests the search as a
``driver.run_ic`` job.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim.zo import ZOConfig
from . import unitary as un

__all__ = ["ICResult", "calibrate_identity", "identity_mse",
           "calibration_sigma", "default_ic_config"]


def calibration_sigma(k: int, n_probes: int = 3, seed: int = 7,
                      device=None) -> torch.Tensor:
    """Known non-degenerate Σ_cal attenuator settings, (n_probes, k):
    permutations of a linspace, as the reference draws them."""
    rng = np.random.default_rng(seed)
    base = np.linspace(0.5, 1.5, k)
    rows = [base] + [rng.permutation(base) for _ in range(n_probes - 1)]
    return torch.as_tensor(np.stack(rows), dtype=torch.float32,
                           device=device)


class ICResult(NamedTuple):
    phi_u: torch.Tensor      # commanded phases, (B, T)
    phi_v: torch.Tensor
    u: torch.Tensor          # realized Ĩ_U readback, (B, k, k)
    v: torch.Tensor          # realized Ĩ_V
    loss: torch.Tensor       # final surrogate loss per block
    mse_u: torch.Tensor      # ‖|U|−I‖² MSE per block (Table 4 metric)
    mse_v: torch.Tensor
    history: torch.Tensor    # best-loss traces, (B, steps//record)


def identity_mse(u: torch.Tensor) -> torch.Tensor:
    k = u.shape[-1]
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    return torch.mean((torch.abs(u) - eye) ** 2, dim=(-2, -1))


def default_ic_config(t_rot: int) -> ZOConfig:
    """The reference's IC budget: ≈ 28·2T probes per restart cycle."""
    return ZOConfig(steps=max(500, 28 * t_rot), inner=2 * t_rot,
                    delta0=0.5, decay=1.05)


def calibrate_identity(gen: torch.Generator | None, n_blocks: int, k: int,
                       model=None, *, kind: str = "clements",
                       method: str = "zcd", cfg: ZOConfig | None = None,
                       dev=None, n_sigma: int = 3, restarts: int = 4,
                       driver=None, device=None,
                       draws: torch.Tensor | None = None) -> ICResult:
    """Run IC on ``n_blocks`` independent k×k PTCs in parallel.

    ``driver``: any :class:`~repro_torch.hw.PhotonicDriver`; when omitted, a
    fresh in-process twin is sampled from ``gen`` on ``device`` (``dev``
    optionally pins its realization).  ``gen`` then also drives the
    search; ``draws`` replaces its per-step draws (see ``hw.jobs``).
    """
    if driver is None:
        from ..hw import make_twin    # lazy: hw sits above core
        driver = make_twin(gen, n_blocks, k, model, kind, dev=dev,
                           device=resolve_device(device))
    elif (driver.n_blocks, driver.k) != (n_blocks, k):
        raise ValueError(
            f"driver hosts {driver.n_blocks} blocks of k={driver.k}, "
            f"caller asked for {n_blocks} blocks of k={k}")
    k = driver.k
    t_rot = un.mesh_spec(k, driver.kind).n_rot
    if cfg is None:
        cfg = default_ic_config(t_rot)
    sigs = calibration_sigma(k, n_probes=n_sigma, device=driver.device)
    res = driver.run_ic(gen, sigs, cfg, restarts=restarts, method=method,
                        draws=draws)
    return ICResult(phi_u=res.phi[:, :t_rot], phi_v=res.phi[:, t_rot:],
                    u=res.u, v=res.v, loss=res.loss,
                    mse_u=identity_mse(res.u), mse_v=identity_mse(res.v),
                    history=res.history)
