"""Digital-twin device physics: the unobservable side of the boundary.

Counterpart of ``repro/hw/device.py``: the fixed, unknown physical state of
a batch of PTC blocks (:class:`DeviceRealization`) and the transfer
function the physical mesh implements for commanded settings.  Control
plane code reaches it only through the driver ops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import unitary as un
from ..core.noise import NoiseModel, PhaseNoise, sample_phase_noise, \
    apply_phase_noise

__all__ = ["DeviceRealization", "sample_device", "realized_unitaries",
           "realized_blocks", "true_mapping_distance", "chip_forward"]


class DeviceRealization(NamedTuple):
    """The fixed, unknown physical state of a batch of PTC blocks.

    Leading dims = block batch (e.g. (B,) flattened blocks).
    """

    noise_u: PhaseNoise     # Γ, Φ_b realizations for the U mesh
    noise_v: PhaseNoise     # ... for the V* mesh
    d_u: torch.Tensor       # ±1 manufacturing sign diagonals
    d_v: torch.Tensor


def sample_device(gen: torch.Generator, batch: tuple[int, ...], k: int,
                  model: NoiseModel, kind: str = "clements",
                  device: torch.device | str | None = None
                  ) -> DeviceRealization:  # repro: noqa[RPL103]
    """Draw a realization from ``gen`` (on the generator's device unless
    ``device`` says otherwise)."""
    device = gen.device if device is None else device
    t = un.mesh_spec(k, kind).n_rot
    nu = sample_phase_noise(gen, batch + (t,), model, device)
    nv = sample_phase_noise(gen, batch + (t,), model, device)
    signs = []
    for _ in range(2):
        coin = torch.rand(batch + (k,), generator=gen, device=device) < 0.5
        signs.append(torch.where(coin, 1.0, -1.0))
    return DeviceRealization(noise_u=nu, noise_v=nv, d_u=signs[0],  # repro: noqa[RPL103]
                             d_v=signs[1])


def realized_unitaries(spec: un.MeshSpec, phi_u, phi_v,
                       dev: DeviceRealization, model: NoiseModel):  # repro: noqa[RPL103]
    """The unitaries the physical mesh implements for commanded Φ, each
    built in one block-batched mesh-kernel launch."""
    pu = apply_phase_noise(spec, phi_u, dev.noise_u, model)
    pv = apply_phase_noise(spec, phi_v, dev.noise_v, model)
    u = un.build_unitary(spec, pu, dev.d_u)
    v = un.build_unitary(spec, pv, dev.d_v)
    return u, v


def realized_blocks(spec: un.MeshSpec, phi: torch.Tensor,
                    sigma: torch.Tensor, dev: DeviceRealization,  # repro: noqa[RPL103]
                    model: NoiseModel) -> torch.Tensor:
    """Ŵ blocks the device implements for commanded ``phi = [Φ^U | Φ^V]``
    (..., 2T) and attenuators ``sigma`` (..., k)."""
    t = spec.n_rot
    u, v = realized_unitaries(spec, phi[..., :t], phi[..., t:], dev, model)  # repro: noqa[RPL103]
    return (u * sigma[..., None, :]) @ v


def true_mapping_distance(spec: un.MeshSpec, phi: torch.Tensor,
                          sigma: torch.Tensor, dev: DeviceRealization,  # repro: noqa[RPL103]
                          model: NoiseModel, w_blocks: torch.Tensor
                          ) -> torch.Tensor:
    """Exact aggregate distance Σ_b‖Ŵ_b − W_b‖² / Σ_b‖W_b‖² (a full
    transfer-matrix readout): the probe estimator's ground truth, which a
    real chip cannot evaluate for free."""
    w_hat = realized_blocks(spec, phi, sigma, dev, model)  # repro: noqa[RPL103]
    num = torch.sum((w_hat - w_blocks) ** 2, dim=(-2, -1))
    den = torch.sum(w_blocks ** 2, dim=(-2, -1)) + 1e-12
    return torch.sum(num) / torch.sum(den)


def chip_forward(spec, phi, sigma, dev, model, x, out_dim):
    """y = Ŵ x through the realized blocks, reassembled into the (P, Q)
    grid of one weight (plain einsum; the twin's serve path uses the PTC
    kernel instead)."""
    k = spec.k
    w_hat = realized_blocks(spec, phi, sigma, dev, model)  # repro: noqa[RPL103]
    b = w_hat.shape[0]
    p = -(-out_dim // k)
    q = b // p
    w = w_hat.reshape(p, q, k, k)
    n = q * k
    xb = x
    if x.shape[-1] != n:
        xb = torch.nn.functional.pad(x, (0, n - x.shape[-1]))
    xb = xb.reshape(x.shape[:-1] + (q, k))
    y = torch.einsum("pqij,...qj->...pi", w, xb)
    y = y.reshape(x.shape[:-1] + (p * k,))
    return y[..., :out_dim]
