"""First-order optimizers (paper §4.1: AdamW), written out.

Counterpart of ``repro/optim/optimizers.py`` on lists of tensors instead of
pytrees: an fp32 master copy over possibly-bf16 params, per-leaf
trainability masking, global-norm clipping (eps 1e-12) and decoupled
weight decay.  Used here for the offline dense pre-training; subspace
learning reuses it on Σ.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["AdamWConfig", "SGDConfig", "OptState", "init_opt_state",
           "apply_updates", "clip_by_global_norm", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-3                # paper: 0.002 for SL-from-scratch
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01      # paper: 0.01
    grad_clip: float | None = 1.0

    kind: str = dataclasses.field(default="adamw", init=False)


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float | None = None

    kind: str = dataclasses.field(default="sgd", init=False)


class OptState(NamedTuple):
    step: int
    mu: list          # first moment / momentum (fp32)
    nu: list          # second moment (fp32; zeros for SGD)
    master: list      # fp32 master params


def init_opt_state(params: list, trainable: list | None = None) -> OptState:
    """Frozen (``trainable`` False) leaves carry no optimizer state."""
    if trainable is None:
        trainable = [True] * len(params)

    def z(a, tr):
        return torch.zeros(a.shape if tr else (), dtype=torch.float32,
                           device=a.device)

    return OptState(
        step=0,
        mu=[z(a, tr) for a, tr in zip(params, trainable)],
        nu=[z(a, tr) for a, tr in zip(params, trainable)],
        master=[a.detach().float().clone() if tr else z(a, False)
                for a, tr in zip(params, trainable)])


def global_norm(tensors: list) -> torch.Tensor:
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(t.float())) for t in tensors])))


def clip_by_global_norm(grads: list, max_norm: float
                        ) -> tuple[list, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return [g * scale for g in grads], norm


@torch.no_grad()
def apply_updates(params: list, grads: list, state: OptState,
                  cfg: AdamWConfig | SGDConfig, lr_scale: float = 1.0,
                  trainable: list | None = None
                  ) -> tuple[list, OptState, torch.Tensor]:
    """One optimizer step; frozen leaves pass through untouched.
    Returns (new_params, new_state, grad_norm)."""
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = cfg.lr * lr_scale
    if trainable is None:
        trainable = [True] * len(params)

    new_p, new_m, new_v, new_master = [], [], [], []
    for p, g, m, v, pm, tr in zip(params, grads, state.mu, state.nu,
                                  state.master, trainable):
        if not tr:
            new_p.append(p)
            new_m.append(m)
            new_v.append(v)
            new_master.append(pm)
            continue
        g = g.float()
        if cfg.kind == "adamw":
            m = cfg.b1 * m + (1 - cfg.b1) * g
            v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            mhat = m / (1 - cfg.b1 ** step)
            vhat = v / (1 - cfg.b2 ** step)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * pm
        else:
            m = cfg.momentum * m + g
            delta = m + cfg.weight_decay * pm
        pm = pm - lr * delta
        new_p.append(pm.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
        new_master.append(pm)
    return new_p, OptState(step=step, mu=new_m, nu=new_v,
                           master=new_master), gnorm
