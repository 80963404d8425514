"""Photonic tensor core (PTC) substrate: blockwise-SVD weight parametrization.

Counterpart of ``repro/core/ptc.py``.  Every ``M×N`` weight is stored as
``P×Q`` blocks of size ``k×k``, each factorized ``W_pq = U_pq Σ_pq V*_pq``:

* :class:`PTCParams`: factor-level parameters ``(u, s, v)``;
* :class:`PTCPhaseParams`: phase-level parameters (MZI rotations + sign
  diagonals), the physical control variables, bridged to and from the
  factors by :func:`phases_to_factors` (through the mesh kernel on a CUDA
  tensor) and :func:`factors_to_phases` (exact float64 decomposition);
* :func:`ptc_forward_blocked` (through the PTC kernel on a CUDA tensor),
  :func:`ptc_forward_fused` (one recomposed dense matmul), and the
  :func:`ptc_forward` dispatcher.

Conventions: ``W`` is ``(M, N) = (out, in)``; a linear layer computes
``y = x @ W.T``; ``w_blocks[p, q] = W[p·k:(p+1)·k, q·k:(q+1)·k]``; ``v``
stores ``V*``, i.e. ``W_pq = u[p,q] @ diag(s[p,q]) @ v[p,q]``.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ptc_block_matmul import ptc_block_matmul
from . import unitary as un
from .noise import NoiseModel, PhaseNoise, apply_phase_noise

__all__ = ["PTCParams", "PTCPhaseParams", "pad_to_blocks", "blockize",
           "unblockize", "svd_factorize", "random_factorize",
           "identity_factorize", "compose_weight", "block_energy",
           "ptc_forward_blocked", "ptc_forward_fused", "ptc_forward",
           "phases_to_factors", "factors_to_phases"]


class PTCParams(NamedTuple):
    """Factor-level PTC parameters for one logical weight matrix.

    u: (P, Q, k, k)  left singular bases
    s: (P, Q, k)     singular values (the subspace-trainable leaf)
    v: (P, Q, k, k)  right bases, stored as V* (acts directly on x)
    """

    u: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor

    @property
    def k(self) -> int:
        return self.u.shape[-1]

    @property
    def grid(self) -> tuple[int, int]:
        return self.u.shape[0], self.u.shape[1]


class PTCPhaseParams(NamedTuple):
    """Phase-level PTC parameters (the physical control variables).

    phi_u / phi_v: (P, Q, T) MZI rotation phases, T = k(k-1)/2
    d_u / d_v:     (P, Q, k) ±1 sign diagonals
    s:             (P, Q, k) singular values (attenuator settings)
    """

    phi_u: torch.Tensor
    d_u: torch.Tensor
    phi_v: torch.Tensor
    d_v: torch.Tensor
    s: torch.Tensor


def pad_to_blocks(m: int, k: int) -> int:
    return (m + k - 1) // k * k


def blockize(w: torch.Tensor, k: int) -> torch.Tensor:
    """(M, N) → (P, Q, k, k), zero-padding trailing edges."""
    m, n = w.shape
    mp, np_ = pad_to_blocks(m, k), pad_to_blocks(n, k)
    if (mp, np_) != (m, n):
        w = F.pad(w, (0, np_ - n, 0, mp - m))
    return w.reshape(mp // k, k, np_ // k, k).permute(0, 2, 1, 3)


def unblockize(blocks: torch.Tensor, m: int | None = None,
               n: int | None = None) -> torch.Tensor:
    """(P, Q, k, k) → (M, N), cropping any padding."""
    p, q, k, _ = blocks.shape
    w = blocks.permute(0, 2, 1, 3).reshape(p * k, q * k)
    if m is not None or n is not None:
        w = w[: m if m is not None else p * k, : n if n is not None else q * k]
    return w


def svd_factorize(w: torch.Tensor, k: int) -> PTCParams:
    """Blockwise SVD of a dense weight — the Parallel-Mapping target init.

    Singular-vector pairs may come out with other signs than
    ``jnp.linalg.svd``'s; the composed blocks and ``s`` are what agree.
    """
    u, s, vh = torch.linalg.svd(blockize(w, k), full_matrices=False)
    return PTCParams(u=u, s=s, v=vh)


def random_factorize(gen: torch.Generator, m: int, n: int, k: int,
                     scale: float | None = None,
                     dtype=torch.float32) -> PTCParams:
    """Random-orthogonal bases + scaled singular values (train-from-scratch),
    on the generator's device.

    ``scale`` defaults to sqrt(2/(M+N)), Glorot-normal-matched: with Haar
    bases E[W_ij²] = E[s²]/k, so s ~ N(0, k·σ_w²).
    """
    device = gen.device
    p, q = pad_to_blocks(m, k) // k, pad_to_blocks(n, k) // k
    u = _random_orthogonal_batch(gen, (p, q), k, dtype, device)
    v = _random_orthogonal_batch(gen, (p, q), k, dtype, device)
    if scale is None:
        scale = math.sqrt(2.0 / (m + n))
    s = scale * math.sqrt(k) * torch.randn((p, q, k), generator=gen,
                                           device=device)
    return PTCParams(u=u, s=s.to(dtype), v=v)


def identity_factorize(m: int, n: int, k: int, dtype=torch.float32,
                       device=None) -> PTCParams:
    """U = V* = I, Σ = 1 — the post-Identity-Calibration circuit state."""
    p, q = pad_to_blocks(m, k) // k, pad_to_blocks(n, k) // k
    eye = torch.eye(k, dtype=dtype, device=device).expand(p, q, k, k)
    return PTCParams(u=eye, s=torch.ones((p, q, k), dtype=dtype,
                                         device=device), v=eye)


def _random_orthogonal_batch(gen: torch.Generator, batch: tuple[int, ...],
                             k: int, dtype, device) -> torch.Tensor:
    """Haar-random orthogonal k×k matrices: QR of a Gaussian, with R's
    diagonal signs moved into Q."""
    g = torch.randn(batch + (k, k), generator=gen, device=device)
    qm, rm = torch.linalg.qr(g)
    qm = qm * torch.sign(torch.diagonal(rm, dim1=-2, dim2=-1))[..., None, :]
    return qm.to(dtype)


def compose_weight(params: PTCParams) -> torch.Tensor:
    """W_pq = U diag(s) V* for every block → (P, Q, k, k)."""
    return (params.u * params.s[..., None, :]) @ params.v


def block_energy(params: PTCParams) -> torch.Tensor:
    """‖W_pq‖_F² = Tr(|Σ_pq|²) — the btopk sampling score (paper §3.4.2),
    (P, Q) in fp32."""
    return torch.sum(params.s.float() ** 2, dim=-1)


def _pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    return x if x.shape[-1] == n else F.pad(x, (0, n - x.shape[-1]))


def ptc_forward_blocked(params: PTCParams, x: torch.Tensor,
                        out_dim: int | None = None) -> torch.Tensor:
    """Paper-faithful photonic dataflow y_p = Σ_q U_pq (s_pq ⊙ (V*_pq x_q)),
    through the PTC kernel on a CUDA tensor."""
    p, q = params.grid
    k = params.k
    xf = _pad_cols(x.reshape(-1, x.shape[-1]), q * k).contiguous()
    y = ptc_block_matmul(xf, params.u.contiguous(), params.s.contiguous(),
                         params.v.contiguous())
    y = y.reshape(x.shape[:-1] + (p * k,))
    if out_dim is not None and out_dim != p * k:
        y = y[..., :out_dim]
    return y


def ptc_forward_fused(params: PTCParams, x: torch.Tensor,
                      out_dim: int | None = None) -> torch.Tensor:
    """Recompose W_eff once, then one dense matmul."""
    p, q = params.grid
    k = params.k
    w = unblockize(compose_weight(params))                   # (P·k, Q·k)
    y = _pad_cols(x, q * k) @ w.T
    if out_dim is not None and out_dim != p * k:
        y = y[..., :out_dim]
    return y


def ptc_forward(params: PTCParams, x: torch.Tensor, *, mode: str = "fused",
                out_dim: int | None = None) -> torch.Tensor:
    """The forward by ``mode``: ``"fused"`` or ``"blocked"``."""
    if mode == "fused":
        return ptc_forward_fused(params, x, out_dim)
    if mode == "blocked":
        return ptc_forward_blocked(params, x, out_dim)
    raise ValueError(f"unknown ptc forward mode: {mode!r}")


# ---------------------------------------------------------------------------
# Phase-level <-> factor-level bridges (used by IC / PM / noise experiments)
# ---------------------------------------------------------------------------


def phases_to_factors(phase_params: PTCPhaseParams,
                      noise_u: PhaseNoise | None = None,
                      noise_v: PhaseNoise | None = None,
                      *, kind: str = "clements",
                      model: NoiseModel | None = None) -> PTCParams:
    """Materialize the (optionally noisy) realized factors from phases:
    the unitaries the mesh implements once ``Ω Γ Q(Φ) + Φ_b`` is applied.

    Each side is one :func:`~repro_torch.core.unitary.build_unitary` call
    over all P·Q blocks (one mesh-kernel launch on a CUDA tensor, so two
    per call); the factors lie on the phases' device."""
    k = phase_params.d_u.shape[-1]
    spec = un.mesh_spec(k, kind)
    phi_u, phi_v = phase_params.phi_u, phase_params.phi_v
    if model is not None and model.enabled:
        if noise_u is None or noise_v is None:
            raise ValueError("phases_to_factors: a noise model needs "
                             "noise_u and noise_v")
        phi_u = apply_phase_noise(spec, phi_u, noise_u, model)
        phi_v = apply_phase_noise(spec, phi_v, noise_v, model)
    u = un.build_unitary(spec, phi_u, phase_params.d_u)
    v = un.build_unitary(spec, phi_v, phase_params.d_v)
    return PTCParams(u=u, s=phase_params.s, v=v)


def factors_to_phases(params: PTCParams, kind: str = "clements",
                      ) -> PTCPhaseParams:
    """Exact per-block mesh decomposition (numpy, float64) of ideal
    factors, as the reference does it; fp32 phases and signs on the
    factors' device."""
    p, q = params.grid
    k = params.k
    u_np = params.u.detach().cpu().double().numpy()
    v_np = params.v.detach().cpu().double().numpy()
    t = un.num_phases(k)
    phi_u = np.zeros((p, q, t))
    phi_v = np.zeros((p, q, t))
    d_u = np.zeros((p, q, k))
    d_v = np.zeros((p, q, k))
    for i in range(p):
        for j in range(q):
            phi_u[i, j], d_u[i, j] = un.decompose(u_np[i, j], kind)
            phi_v[i, j], d_v[i, j] = un.decompose(v_np[i, j], kind)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=params.u.device)

    return PTCPhaseParams(phi_u=f32(phi_u), d_u=f32(d_u), phi_v=f32(phi_v),
                          d_v=f32(d_v), s=params.s)
