"""Multi-level sparsity for in-situ subspace gradients (paper §3.4.2).

Counterpart of ``repro/core/sparsity.py``.  Three levels:

* **Feedback sampling** — a structured block mask on the feedback matrix
  ``W^T``, ``S_W ∈ {0,1}^{Q×P}``: ``uniform`` (exactly-keep per row on
  uniform noise), ``topk`` (global greedy by block energy) or ``btopk``
  (energy plus Gumbel noise, exactly ``round(α·P)`` blocks per row);
  normalized by ``none``, ``exp`` (×1/α, unbiased) or ``var`` (×1/√α).
* **Column sampling** — drop im2col columns / tokens of the gradient
  contraction with one mask shared across the batch.
* **Data sampling (SMD)** — skip a whole iteration with probability α_D.

Each sampler is a draw from a ``torch.Generator`` and a deterministic
function of that draw; passing the draw (``noise=``, ``idx=``, ``u=``)
skips the generator, so tests can hand both packages the same numbers.
Ties in every ranking go to the lowest index, as ``lax.top_k`` and
JAX's stable ``argsort`` break them (a stable sort here).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["SparsityConfig", "DENSE", "feedback_mask", "column_mask",
           "smd_keep_iteration", "accumulation_depths"]


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Static sampling configuration for one training run."""

    alpha_w: float = 1.0            # feedback density (1.0 = dense)
    feedback_mode: str = "btopk"    # uniform | topk | btopk
    feedback_norm: str = "exp"      # none | exp | var
    alpha_c: float = 1.0            # column/token density
    column_norm: str = "none"       # paper adopts α_C-scale off (§3.4.2)
    alpha_d: float = 0.0            # SMD iteration-skip probability

    @property
    def enabled(self) -> bool:
        return self.alpha_w < 1.0 or self.alpha_c < 1.0

    def normalizer(self, alpha: float, kind: str) -> float:
        if kind == "none" or alpha >= 1.0:
            return 1.0
        if kind == "exp":
            return 1.0 / alpha
        if kind == "var":
            return 1.0 / math.sqrt(alpha)
        raise ValueError(f"unknown normalization: {kind!r}")


DENSE = SparsityConfig()


def _top_indices(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Indices of the ``keep`` largest entries along the last axis, ties to
    the lowest index (``torch.topk`` promises no tie order)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][
        ..., :keep]


def _row_balanced_topk(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """Keep the ``keep`` largest entries of every row → boolean mask."""
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter_(-1, _top_indices(scores, keep), True)


def feedback_mask(gen: torch.Generator | None, block_energy: torch.Tensor,
                  cfg: SparsityConfig, *,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``S_W ∈ {0,1}^{Q×P}`` — the mask over blocks of ``W^T``.

    ``block_energy`` is ‖W_pq‖_F², (P, Q) in the forward-block layout; the
    mask indexes the feedback orientation (Q, P).  ``noise`` (Q, P) is the
    uniform draw of the ``uniform`` mode (in [0, 1)) or of ``btopk`` (in
    [1e-20, 1)); drawn from ``gen`` when not given.  Returns an fp32 mask
    already scaled by the normalizer c_W.
    """
    p, q = block_energy.shape
    alpha = cfg.alpha_w
    dev = block_energy.device
    if alpha >= 1.0:
        return torch.ones((q, p), dtype=torch.float32, device=dev)
    scores = block_energy.T.float()                          # (Q, P)
    keep = max(1, int(round(alpha * p)))
    if cfg.feedback_mode not in ("uniform", "topk", "btopk"):
        raise ValueError(f"unknown feedback mode: {cfg.feedback_mode!r}")
    if noise is None and cfg.feedback_mode != "topk":
        noise = torch.rand((q, p), generator=gen, device=dev)
        if cfg.feedback_mode == "btopk":
            noise = noise.clamp_min(1e-20)
    if cfg.feedback_mode == "uniform":
        # exactly-keep uniform per row: the importance-unaware baseline
        mask = _row_balanced_topk(noise, keep)
    elif cfg.feedback_mode == "topk":
        # global greedy top round(α·P·Q) blocks regardless of row: biased
        # and load-imbalanced (paper Fig. 7)
        total = max(1, int(round(alpha * p * q)))
        idx = _top_indices(scores.reshape(-1), total)
        mask = torch.zeros(q * p, dtype=torch.bool, device=dev)
        mask = mask.index_fill_(0, idx, True).reshape(q, p)
    else:
        # guided distribution: energy + Gumbel noise, row-balanced top-K
        guided = torch.log(scores + 1e-12) - torch.log(-torch.log(noise))
        mask = _row_balanced_topk(guided, keep)
    return mask.float() * cfg.normalizer(keep / p, cfg.feedback_norm)


def column_mask(gen: torch.Generator | None, n_cols: int,
                cfg: SparsityConfig, *,
                idx: torch.Tensor | None = None) -> torch.Tensor:
    """Shared-across-batch column/token mask, scaled by the column norm,
    on the device of ``idx`` (else of ``gen``).

    ``idx`` is the draw: ``round(α_C·n_cols)`` distinct kept columns,
    drawn from ``gen`` (a random permutation's head) when not given.
    """
    device = idx.device if idx is not None else gen.device
    if cfg.alpha_c >= 1.0:
        return torch.ones((n_cols,), dtype=torch.float32, device=device)
    keep = max(1, int(round(cfg.alpha_c * n_cols)))
    if idx is None:
        idx = torch.randperm(n_cols, generator=gen, device=device)[:keep]
    if idx.shape != (keep,):
        raise ValueError(f"column_mask: {tuple(idx.shape)} indices, "
                         f"expected ({keep},)")
    mask = torch.zeros((n_cols,), dtype=torch.float32, device=device)
    mask[idx] = 1.0
    return mask * cfg.normalizer(keep / n_cols, cfg.column_norm)


def smd_keep_iteration(gen: torch.Generator | None, cfg: SparsityConfig, *,
                       u: float | None = None) -> bool:
    """Stochastic mini-batch dropping: True = run this iteration.

    ``u`` is the draw, uniform in [0, 1); drawn from ``gen`` when not
    given (one scalar, read on the host).
    """
    if cfg.alpha_d <= 0.0:
        return True
    if u is None:
        u = float(torch.rand((), generator=gen, device=gen.device))
    return u >= cfg.alpha_d


def accumulation_depths(mask: torch.Tensor) -> torch.Tensor:
    """Per-output-row partial-product chain length (latency model, Fig. 7).

    The feedback latency is bottlenecked by the LONGEST accumulation path;
    btopk equalizes these by construction.
    """
    return (mask > 0).sum(dim=-1)
