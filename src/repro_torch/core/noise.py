"""Optical circuit non-ideality models (paper §3.1, Appendix A.3).

Counterpart of ``repro/core/noise.py``.  Noisy effective phases follow the
paper's composition ``W(Ω Γ Q(Φ) + Φ_b)``:

* ``Q(·)``  — b-bit uniform quantization of the rotation phases in [0, 2π);
* ``Γ``     — static multiplicative phase-shifter variation ``~ N(1, σ_γ²)``;
* ``Ω``     — thermal crosstalk between adjacent MZIs of one mesh column;
* ``Φ_b``   — unknown static phase bias ``~ U(0, 2π)``.

Γ and Φ_b are device realizations, sampled once per PTC instance.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .unitary import MeshSpec, mesh_spec

__all__ = ["NoiseModel", "PhaseNoise", "sample_phase_noise", "quantize_phase",
           "crosstalk_couple", "apply_phase_noise", "IDEAL", "DEFAULT_NOISE"]

TWO_PI = 2.0 * np.pi


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Static configuration of circuit non-idealities."""

    enabled: bool = True
    phase_bits: int | None = 8      # Q(·) resolution for U/V* rotation phases
    sigma_bits: int | None = None   # Σ control resolution (None = analog/high)
    gamma_std: float = 0.002        # phase-shifter variation σ_γ
    crosstalk: float = 0.005        # adjacent-MZI mutual coupling ω
    phase_bias: bool = True         # unknown Φ_b ~ U(0, 2π)

    def off(self) -> "NoiseModel":
        return dataclasses.replace(self, enabled=False)

    def post_ic(self) -> "NoiseModel":
        """The noise frame AFTER Identity Calibration: Φ_b is compensated by
        the controller's learned bias corrections; Q/Γ/Ω remain."""
        return dataclasses.replace(self, phase_bias=False)


IDEAL = NoiseModel(enabled=False)
DEFAULT_NOISE = NoiseModel()


class PhaseNoise(NamedTuple):
    """A sampled device realization for one batch of phase vectors."""

    gamma: torch.Tensor  # multiplicative, ~N(1, σ²)
    bias: torch.Tensor   # additive, ~U(0, 2π)


def sample_phase_noise(gen: torch.Generator, shape: tuple[int, ...],
                       model: NoiseModel,
                       device: torch.device | str | None = None) -> PhaseNoise:
    """Draw Γ and Φ_b from ``gen`` (the generator's device by default)."""
    device = gen.device if device is None else device
    if not model.enabled:
        return PhaseNoise(torch.ones(shape, device=device),
                          torch.zeros(shape, device=device))
    gamma = 1.0 + model.gamma_std * torch.randn(shape, generator=gen,
                                                device=device)
    if model.phase_bias:
        bias = TWO_PI * torch.rand(shape, generator=gen, device=device)
    else:
        bias = torch.zeros(shape, device=device)
    return PhaseNoise(gamma, bias)


def quantize_phase(phases: torch.Tensor, bits: int | None) -> torch.Tensor:
    """Paper Eq. (9): uniform b-bit quantization on [0, 2π).

    ``torch.round`` rounds half to even like ``jnp.round``, and
    ``torch.remainder`` takes the divisor's sign like ``jnp.mod``.
    """
    if bits is None:
        return phases
    step = TWO_PI / (2 ** bits - 1)
    return torch.round(torch.remainder(phases, TWO_PI) / step) * step


@functools.lru_cache(maxsize=64)
def _neighbors(k: int, kind: str, device: torch.device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The spec's crosstalk adjacency table, kept on ``device``: each
    phase's (T, 2) neighbour indices (the −1 padding read as 0) and which
    of them are real."""
    neigh = torch.as_tensor(mesh_spec(k, kind).phase_neighbors.astype(np.int64),
                            device=device)
    return neigh.clamp(min=0), neigh >= 0


def crosstalk_couple(spec: MeshSpec, phases: torch.Tensor,
                     omega: float) -> torch.Tensor:
    """φ_c = Ω φ — add ω · (sum of same-column neighbour phases)."""
    if omega == 0.0:
        return phases
    idx, real = _neighbors(spec.k, spec.kind, phases.device)  # (T, 2)
    gathered = torch.where(real, phases[..., idx], 0.0)       # (..., T, 2)
    return phases + omega * gathered.sum(-1)


def apply_phase_noise(spec: MeshSpec, phases: torch.Tensor,
                      noise: PhaseNoise, model: NoiseModel) -> torch.Tensor:
    """Effective phases ``Ω Γ Q(Φ) + Φ_b`` fed to the physical mesh."""
    if not model.enabled:
        return phases
    q = quantize_phase(phases, model.phase_bits)
    v = noise.gamma * q
    c = crosstalk_couple(spec, v, model.crosstalk)
    return c + noise.bias
