"""Neural-net layers over the PTC substrate: the PTC linear.

Counterpart of the PTC-linear part of ``repro/models/layers.py``: every
projection is a PTC linear — blockwise (U, Σ, V*) factors with Σ the only
first-order-trainable hardware leaf.  Parameters are plain dicts of
tensors; Σ is stored in fp32.

The reference module's dense electronic baseline (``mode="dense"``),
execution hook and scopes, sharding constraints, ``partition`` /
``combine``, norms, rotary, soft-cap and embedding belong to the LM slice
of the port and are not here yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.ptc import PTCParams, random_factorize
from ..core.subspace import SubspaceMasks, ptc_linear

__all__ = ["PTCLinearCfg", "init_ptc_linear", "apply_ptc_linear",
           "is_ptc_leaf", "trainable_mask"]

Params = dict


@dataclasses.dataclass(frozen=True)
class PTCLinearCfg:
    """Static policy for every PTC linear in a model."""

    k: int = 128                         # block size (9 = paper)
    mode: str = "fused"                  # fused | blocked
    base_dtype: torch.dtype = torch.bfloat16   # frozen U/V storage dtype


def init_ptc_linear(gen: torch.Generator, d_in: int, d_out: int,
                    cfg: PTCLinearCfg, bias: bool = False) -> Params:
    """One layer's parameters on the generator's device."""
    f = random_factorize(gen, d_out, d_in, cfg.k)
    p: Params = {"u": f.u.to(cfg.base_dtype), "s": f.s.float(),
                 "v": f.v.to(cfg.base_dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def is_ptc_leaf(path: tuple) -> bool:
    """True for the trainable Σ leaf of a PTC linear (key 's')."""
    return path[-1] == "s"


def apply_ptc_linear(p: Params, x: torch.Tensor, cfg: PTCLinearCfg,
                     masks: SubspaceMasks | None = None,
                     d_out: int | None = None) -> torch.Tensor:
    """y = x @ Wᵀ (+b): zero-pads x to the block grid's Q·k columns and
    crops y to ``d_out``."""
    params = PTCParams(u=p["u"], s=p["s"].to(p["u"].dtype), v=p["v"])
    pp, qq = params.grid
    k = params.k
    if x.shape[-1] != qq * k:
        x = F.pad(x, (0, qq * k - x.shape[-1]))
    y = ptc_linear(x.to(params.u.dtype), params, masks, mode=cfg.mode)
    if d_out is not None and d_out != pp * k:
        y = y[..., :d_out]
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def trainable_mask(params: Params) -> Params:
    """Bool tree of ``params``' shape: True = the optimizer updates this
    leaf.  Everything but the frozen U/V bases (Σ and biases)."""
    return {name: trainable_mask(leaf) if isinstance(leaf, dict)
            else name not in ("u", "v") for name, leaf in params.items()}
