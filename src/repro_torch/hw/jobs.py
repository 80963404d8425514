"""On-controller in-situ search jobs (device-side code).

Counterpart of ``repro/hw/jobs.py``.  A ZO loss measurement is a physical
probe, so the searches run next to the device:

* :func:`phase_refine` — the warm alternate ZCD of PM's stage 2;
* :func:`ic_search` — IC's multi-Σ_cal surrogate search (§3.2, Eq. 2).

Every block is an independent sub-problem; where the reference
``jax.vmap``s a per-block ``lax.scan``, all blocks' state here is one
(B, 2T) tensor (:func:`repro_torch.optim.zo.zo_minimize`).  One probe
rebuilds U and V of every block (mesh kernel) and streams the k unit
vectors through each block's realized ``UΣV*`` (PTC kernel) — the
measurement the reference writes as a dense block product.
"""

from __future__ import annotations

import torch

from ..core import unitary as un
from ..core.noise import NoiseModel
from ..kernels.ptc_block_matmul import ptc_block_matmul
from ..optim.zo import ZOConfig, ZOResult, step_draws, zo_minimize
from .device import DeviceRealization, realized_unitaries

__all__ = ["phase_refine", "ic_search", "probe_transfer", "job_draws"]


def job_draws(gen: torch.Generator, method: str, b: int, steps: int,
              n_rot: int, restarts: int | None = None) -> torch.Tensor:
    """The per-step draws a job makes from ``gen``, made now: those of
    :func:`phase_refine` (alternating halves of the 2T phases), or with
    ``restarts`` those of :func:`ic_search` (one stack a restart).  A job
    given them as ``draws`` gives the bits ``gen`` gives; a transport that
    ships a job to another process or device sends these in its place."""
    n = 2 * n_rot
    if restarts is None:
        return step_draws(gen, method, b, steps, n, n_rot)
    return torch.stack([step_draws(gen, method, b, steps, n)
                        for _ in range(restarts)])


def probe_transfer(u: torch.Tensor, s: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Ŵ_b = U_b diag(s_b) V*_b, (B, k, k), measured as the k unit vectors
    through every block: the PTC forward on a (B, 1) block grid."""
    b, k, _ = u.shape
    eye = torch.eye(k, dtype=u.dtype, device=u.device)
    y = ptc_block_matmul(eye, u[:, None], s[:, None], v[:, None])
    return y.reshape(k, b, k).permute(1, 2, 0)   # y[j, b, i] = Ŵ_b[i, j]


def _block_distance(w_hat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Normalized ‖W−W̃‖²/‖W‖² per block (as mapping.matrix_distance)."""
    num = torch.sum((w_hat - w) ** 2, dim=(-2, -1))
    den = torch.sum(w ** 2, dim=(-2, -1)) + 1e-12
    return num / den


def phase_refine(spec: un.MeshSpec, model: NoiseModel,
                 dev: DeviceRealization, phi0: torch.Tensor,  # repro: noqa[RPL103]
                 sigma: torch.Tensor, w_blocks: torch.Tensor,
                 gen: torch.Generator | None, cfg: ZOConfig,
                 method: str = "zcd",
                 draws: torch.Tensor | None = None) -> ZOResult:
    """Alternate ZCD on ``phi = [Φ^U | Φ^V]`` (B, 2T) against per-block
    targets, warm-started from ``phi0``."""
    t = spec.n_rot
    sigma = sigma.contiguous()

    def loss(ph):
        u, v = realized_unitaries(spec, ph[:, :t], ph[:, t:], dev, model)  # repro: noqa[RPL103]
        return _block_distance(probe_transfer(u, sigma, v), w_blocks)

    return zo_minimize(loss, phi0, cfg, method, alt_split=t, gen=gen,
                       draws=draws)


def ic_search(spec: un.MeshSpec, model: NoiseModel, dev: DeviceRealization,  # repro: noqa[RPL103]
              gen: torch.Generator | None, cfg: ZOConfig,
              sigs: torch.Tensor, method: str = "zcd", restarts: int = 4,
              draws: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Identity Calibration's surrogate search (Eq. 2).

    One loss measurement probes every block with the k unit vectors per
    Σ_cal setting (``sigs``, (n_sigma, k)) and compares the intensities of
    ``U Σ V* Σ⁻¹`` with I.  ``restarts`` cyclic restarts halve δ₀ each
    cycle.  ``draws``, if given, holds each restart's per-step draws
    (restarts, B, steps[, n]).  Returns ``(phi, final_loss, history)``.
    """
    t = spec.n_rot
    n_blocks = dev.d_u.shape[0]
    k = spec.k
    eye = torch.eye(k, dtype=torch.float32, device=sigs.device)
    sig_rows = [sig.expand(n_blocks, k).contiguous() for sig in sigs]

    def loss(phi):
        u, v = realized_unitaries(spec, phi[:, :t], phi[:, t:], dev, model)  # repro: noqa[RPL103]
        total = 0.0
        for sig, sig_b in zip(sigs, sig_rows):
            m = probe_transfer(u, sig_b, v) / sig   # U Σ V* Σ⁻¹, Σ⁻¹ electronic
            total = total + torch.mean((torch.abs(m) - eye) ** 2, dim=(-2, -1))
        return total / len(sig_rows)

    x = torch.zeros((n_blocks, 2 * t), dtype=torch.float32,
                    device=sigs.device)
    histories = []
    res = None
    for r in range(restarts):
        cfg_r = cfg._replace(delta0=cfg.delta0 / (2.0 ** r))
        res = zo_minimize(loss, x, cfg_r, method, gen=gen,
                          draws=None if draws is None else draws[r])
        x = res.x
        histories.append(res.history)
    return x, res.f, torch.cat(histories, dim=-1)
