"""Parallel Mapping (PM): alternate-projection model deployment (§3.3).

Counterpart of ``repro/core/mapping.py``.  Maps a pre-trained weight onto
the noisy MZI meshes as a batched blockwise regression:

1. SVD + exact mesh parametrization (fp64, all blocks in one batched pass,
   ``unitary.decompose_batched``) — the *commanded* phases;
2. alternate ZCD on Φ^U / Φ^V against ``‖W̃_pq(Φ) − W_pq‖²``, requested as
   an in-situ ``driver.zo_refine`` job;
3. Optimal Singular-value Projection (OSP), Claim 1:
   ``Σ_opt = diag(U* W V)`` on the read-back realized bases.

Pure control-plane code: every device interaction goes through the
:class:`~repro_torch.hw.PhotonicDriver` boundary.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..optim.zo import ZOConfig
from . import unitary as un
from .ptc import PTCParams, blockize, svd_factorize

__all__ = ["PMResult", "parallel_map", "osp", "matrix_distance",
           "default_pm_config"]


class PMResult(NamedTuple):
    params: PTCParams          # realized factors after PM (+OSP)
    phi_u: torch.Tensor        # commanded phases
    phi_v: torch.Tensor
    err_init: torch.Tensor     # normalized ‖W̃−W‖²/‖W‖² at commanded-SVD init
    err_zo: torch.Tensor       # ... after alternate ZO
    err_osp: torch.Tensor      # ... after OSP (the Fig. 5 "error drop")
    history: torch.Tensor
    driver: object             # the PhotonicDriver the weight was deployed on
    decompose_s: float         # wall seconds of the batched decomposition


def matrix_distance(w_hat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Normalized matrix distance ‖W−W̃‖²/‖W‖² (paper Fig. 5 metric)."""
    num = torch.sum((w_hat - w) ** 2, dim=(-2, -1))
    den = torch.sum(w ** 2, dim=(-2, -1)) + 1e-12
    return num / den


def osp(u: torch.Tensor, v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Claim 1: Σ_opt = diag(U* W V) with V* stored in ``v``; sign flips in
    the realized bases cancel on the diagonal."""
    return torch.einsum("...ji,...jl,...il->...i", u, w, v)


def default_pm_config(t_rot: int) -> ZOConfig:
    """The reference's PM budget."""
    return ZOConfig(steps=max(300, 10 * t_rot), inner=2 * t_rot,
                    delta0=2 * np.pi / 255.0 * 8, decay=1.05)


def parallel_map(gen: torch.Generator | None, w: torch.Tensor, k: int,
                 model=None, *, kind: str = "clements", method: str = "zcd",
                 cfg: ZOConfig | None = None, dev=None, run_zo: bool = True,
                 driver=None, block_range: tuple[int, int] | None = None,
                 device=None, draws: torch.Tensor | None = None
                 ) -> PMResult:
    """Map a dense weight ``w`` (M, N) onto noisy k×k PTC blocks.

    Returns the REALIZED factor-level parameters.  ``driver`` defaults to
    a fresh twin sampled from ``gen`` on ``device`` (``dev`` optionally
    pins its realization); ``gen`` then also drives the ZO job, whose
    per-step draws ``draws`` can replace.  ``block_range`` deploys onto a
    tenant slice of an explicit shared ``driver``.
    """
    if driver is None:
        device = resolve_device(device)
    else:
        device = driver.device
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    spec = un.mesh_spec(k, kind)
    t = spec.n_rot
    ideal = svd_factorize(w, k)
    p, q = ideal.grid
    b = p * q
    w_blocks = blockize(w, k).reshape(b, k, k)

    # Step 1 — exact parametrization of the ideal factors (fp64, every
    # block in one batched pass on the weight's device).
    t0 = time.perf_counter()
    phi_u0, d_u0 = un.decompose_batched(
        ideal.u.detach().double().reshape(b, k, k), kind)
    phi_v0, d_v0 = un.decompose_batched(
        ideal.v.detach().double().reshape(b, k, k), kind)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    decompose_s = time.perf_counter() - t0

    if driver is None:
        if block_range is not None:
            raise ValueError("block_range deployment needs an explicit "
                             "driver (the shared multi-tenant chip)")
        from ..hw import make_twin    # lazy: hw sits above core
        driver = make_twin(gen, b, k, model, kind, m=w.shape[0],
                           n=w.shape[1], dev=dev, device=device)
    if block_range is None and driver.n_blocks != b:
        raise ValueError(f"driver hosts {driver.n_blocks} blocks, "
                         f"weight needs {b}")
    if block_range is not None and block_range[1] - block_range[0] != b:
        raise ValueError(f"block_range {block_range!r} spans "
                         f"{block_range[1] - block_range[0]} blocks, "
                         f"weight needs {b}")

    # deploy the commanded state: signs from the decomposition (the
    # crossing configuration is commanded; Γ/Φ_b stay the device's own)
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    driver.write_signs(f32(d_u0), f32(d_v0), block_range=block_range)
    driver.write_phases(f32(phi_u0), f32(phi_v0), block_range=block_range)
    driver.write_sigma(ideal.s.reshape(b, k), block_range=block_range)

    from ..hw.driver import readout_blocks
    err_init = matrix_distance(readout_blocks(driver,
                                              block_range=block_range),
                               w_blocks)

    if run_zo:
        if cfg is None:
            cfg = default_pm_config(t)
        res = driver.zo_refine(w_blocks, gen, cfg, method=method,
                               block_range=block_range, draws=draws)
        phi, err_zo, history = res.phi, res.loss, res.history
    else:
        phi = torch.cat([f32(phi_u0), f32(phi_v0)], dim=-1)
        err_zo, history = err_init, err_init[:, None]

    # Step 3 — OSP on the realized bases (reciprocal readback probes).
    u_real, v_real = driver.readback_bases(block_range=block_range)
    s_opt = osp(u_real, v_real, w_blocks)
    w_hat = (u_real * s_opt[..., None, :]) @ v_real
    err_osp = matrix_distance(w_hat, w_blocks)
    driver.write_sigma(s_opt, block_range=block_range)

    params = PTCParams(u=u_real.reshape(p, q, k, k),
                       s=s_opt.reshape(p, q, k),
                       v=v_real.reshape(p, q, k, k))
    return PMResult(params=params, phi_u=phi[:, :t], phi_v=phi[:, t:],
                    err_init=err_init, err_zo=err_zo, err_osp=err_osp,
                    history=history, driver=driver, decompose_s=decompose_s)
