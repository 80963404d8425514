"""Feed-forward layers: the gated MLP over PTC linears.

Counterpart of the dense part of ``repro/models/ffn.py``.  The top-k MoE
with ragged expert dispatch belongs to a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import PTCLinearCfg, apply_ptc_linear, init_ptc_linear

__all__ = ["FFNCfg", "init_mlp", "mlp"]

Params = dict


@dataclasses.dataclass(frozen=True)
class FFNCfg:
    d_model: int
    d_ff: int
    act: str = "silu"      # silu | gelu


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":             # jax.nn.gelu's default: the tanh form
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def init_mlp(gen: torch.Generator, cfg: FFNCfg, lin: PTCLinearCfg) -> Params:
    return {
        "gate": init_ptc_linear(gen, cfg.d_model, cfg.d_ff, lin),
        "up": init_ptc_linear(gen, cfg.d_model, cfg.d_ff, lin),
        "down": init_ptc_linear(gen, cfg.d_ff, cfg.d_model, lin),
    }


def mlp(p: Params, cfg: FFNCfg, lin: PTCLinearCfg,
        x: torch.Tensor) -> torch.Tensor:
    g = apply_ptc_linear(p["gate"], x, lin, d_out=cfg.d_ff, name="gate")
    u = apply_ptc_linear(p["up"], x, lin, d_out=cfg.d_ff, name="up")
    return apply_ptc_linear(p["down"], _act(cfg.act, g) * u, lin,
                            d_out=cfg.d_model, name="down")
