"""Paper Fig. 8: gradient approximation fidelity of the sampled in-situ
estimators — average angular similarity and normalized distance vs
(a) feedback sparsity / strategy, (b) normalization, (c) column vs
spatial sampling for CONV.

Counterpart of ``benchmarks/grad_fidelity.py``.  The layer is the blocked
``ptc_linear`` at k = 9 on a 72 × 72 weight with T = 128 rows (P = Q = 8),
so on the card every gradient runs the three k <= 32 PTC kernels: the
forward's product route, ``sigma_grad`` for the Σ-gradients and
``feedback_matmul`` for the input gradients.  ``jax.vjp`` becomes
``torch.autograd.grad``.  :func:`draw` makes every random input on the
host; :func:`fig8ab` and :func:`fig8cd` compute on ``device``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.ptc import PTCParams, block_energy, random_factorize
from ..core.sparsity import SparsityConfig, column_mask, feedback_mask
from ..core.subspace import SubspaceMasks, ptc_linear
from ..device import resolve_device
from .common import cpu_generator, emit, to_device

__all__ = ["Draws", "draw", "n_mc", "true_grads", "fig8ab", "fig8cd",
           "main"]

M = N = 72
K = 9
T = 128
STRATEGIES = ("uniform", "topk", "btopk")
ALPHAS = (0.3, 0.6)
NORMS = ("none", "exp", "var")


class Draws(NamedTuple):
    """Every random input of Fig. 8."""

    params: PTCParams     # random factors with skewed block energies
    x: torch.Tensor       # (T, N)
    dy: torch.Tensor      # (T, M)
    fb_noise: torch.Tensor  # (n_mc, Q, P) uniform in [1e-20, 1): the
    #                         feedback samplers' draw (one per MC sample,
    #                         shared by every strategy, density and norm)
    col_idx: dict         # alpha -> (n_mc, round(alpha·T)) kept columns
    spatial: dict         # alpha -> (n_mc, N) bool: kept input features


def n_mc(budget: str) -> int:
    return 24 if budget == "quick" else 64


def draw(gen: torch.Generator, mc: int) -> Draws:
    """Fig. 8's draws on ``gen``'s device (x and δy from numpy's
    ``default_rng(0)``, as the reference draws them)."""
    rng = np.random.default_rng(0)
    params = random_factorize(gen, M, N, K)
    p, q = params.grid
    # skew block energies (real layers are skewed) so btopk has signal
    skew = torch.exp(1.5 * torch.randn((p, q, 1), generator=gen,
                                       device=gen.device))
    params = PTCParams(params.u, params.s * skew, params.v)
    x = torch.from_numpy(rng.standard_normal((T, N)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((T, M)).astype(np.float32))
    noise = torch.rand((mc, q, p), generator=gen,
                       device=gen.device).clamp_min(1e-20)
    col_idx, spatial = {}, {}
    for alpha in ALPHAS:
        keep = max(1, int(round(alpha * T)))
        col_idx[alpha] = torch.stack([
            torch.randperm(T, generator=gen, device=gen.device)[:keep]
            for _ in range(mc)])
        spatial[alpha] = torch.rand((mc, N), generator=gen,
                                    device=gen.device) < alpha
    return Draws(params, x.to(gen.device), dy.to(gen.device), noise,
                 col_idx, spatial)


def _blocked(x, u, s, v, masks=None):
    return ptc_linear(x, PTCParams(u, s, v), masks, mode="blocked")


def true_grads(params: PTCParams, x: torch.Tensor, dy: torch.Tensor):
    """(∂L/∂x, ∂L/∂Σ) of the unsampled blocked layer for upstream δy."""
    xx = x.detach().requires_grad_(True)
    ss = params.s.detach().requires_grad_(True)
    y = _blocked(xx, params.u, ss, params.v)
    return torch.autograd.grad(y, (xx, ss), dy)


def _angular(a, b) -> torch.Tensor:
    return torch.sum(a * b) / (torch.linalg.vector_norm(a)
                               * torch.linalg.vector_norm(b) + 1e-12)


def _ndist(a, b) -> torch.Tensor:
    return torch.sum((a - b) ** 2) / (torch.sum(b ** 2) + 1e-12)


def _mean(vals: list[torch.Tensor]) -> float:
    """The mean of per-sample fp32 metrics, summed in fp64 (one host read
    per configuration)."""
    return float(torch.stack(vals).double().sum()) / len(vals)


def fig8ab(d: Draws) -> list[list]:
    """(a)/(b): the input gradient under each feedback strategy, density
    and normalization; rows [strategy, alpha_keep, norm, angular sim,
    normalized distance], unrounded."""
    dx_true, _ = true_grads(d.params, d.x, d.dy)
    be = block_energy(d.params)
    rows = []
    for mode in STRATEGIES:
        for alpha in ALPHAS:
            for norm in NORMS:
                cfg = SparsityConfig(alpha_w=alpha, feedback_mode=mode,
                                     feedback_norm=norm)
                cs, nd = [], []
                for noise in d.fb_noise:
                    masks = SubspaceMasks(feedback_mask(
                        None, be, cfg, noise=noise), None)
                    xx = d.x.detach().requires_grad_(True)
                    y = _blocked(xx, d.params.u, d.params.s, d.params.v,
                                 masks)
                    g = torch.autograd.grad(y, xx, d.dy)[0]
                    cs.append(_angular(g, dx_true))
                    nd.append(_ndist(g, dx_true))
                rows.append([mode, alpha, norm, _mean(cs), _mean(nd)])
    return rows


def fig8cd(d: Draws) -> list[list]:
    """(c)/(d): the Σ-gradient under column sampling (whole columns of the
    contraction dropped, exp-normalized) and spatial sampling (input
    features dropped, RAD-style); rows [sampling, alpha_keep, angular
    sim, normalized distance], unrounded."""
    _, ds_true = true_grads(d.params, d.x, d.dy)
    u, v = d.params.u, d.params.v
    rows = []
    for alpha in ALPHAS:
        for kind in ("column", "spatial"):
            cfg = SparsityConfig(alpha_c=alpha, column_norm="exp")
            cs, nd = [], []
            for i in range(d.fb_noise.shape[0]):
                ss = d.params.s.detach().requires_grad_(True)
                if kind == "column":
                    col = column_mask(None, T, cfg, idx=d.col_idx[alpha][i])
                    y = _blocked(d.x, u, ss, v, SubspaceMasks(None, col))
                else:
                    keep = d.spatial[alpha][i].to(d.x.dtype)
                    y = _blocked(d.x * keep[None, :] / alpha, u, ss, v)
                gs = torch.autograd.grad(y, ss, d.dy)[0]
                cs.append(_angular(gs, ds_true))
                nd.append(_ndist(gs, ds_true))
            rows.append([kind, alpha, _mean(cs), _mean(nd)])
    return rows


def main(budget: str = "normal", device=None) -> dict:
    """Emit Fig. 8(a)-(d) on ``device`` (default ``cuda``); returns
    {table: rows} with the reference's 4-decimal rounding."""
    dev = resolve_device(device)
    d = to_device(draw(cpu_generator(0), n_mc(budget)), dev)
    tables = {
        "fig8ab_feedback_fidelity": [
            r[:3] + [round(r[3], 4), round(r[4], 4)] for r in fig8ab(d)],
        "fig8cd_column_vs_spatial": [
            r[:2] + [round(r[2], 4), round(r[3], 4)] for r in fig8cd(d)]}
    emit("fig8ab_feedback_fidelity",
         ["strategy", "alpha_keep", "norm", "avg_angular_sim",
          "avg_norm_dist"], tables["fig8ab_feedback_fidelity"])
    emit("fig8cd_column_vs_spatial",
         ["sampling", "alpha_keep", "avg_angular_sim", "avg_norm_dist"],
         tables["fig8cd_column_vs_spatial"])
    return tables


if __name__ == "__main__":
    main()
