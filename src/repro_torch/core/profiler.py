"""Hardware cost profiler: the paper's Appendix-G PTC energy / step model.

Counterpart of ``repro/core/profiler.py`` (pure Python, copied so the
port imports nothing of the reference).

The paper's simulator "counts the total number of PTC calls as the
normalized energy indicator and the longest accumulation path as the
normalized latency/runtime indicator".  We reproduce that cost model so
the Table-2 / Fig-10 / Fig-11 benchmarks can be emitted:

Energy (PTC calls), per layer with P×Q blocks and n_cols = B·H'·W'
streamed input columns (tokens for LM layers, im2col columns for CONV):

    E_fwd  = P·Q·n_cols
    E_∇Σ   = 2 · P·Q · (α_C·n_cols)      (2 reciprocal PTC passes, Eq. 5)
    E_∇x   = (keep_W·P)·Q · n_cols       (masked feedback blocks idle)

Time steps (k adders per PTC, sequential cross-PTC reduction, parallel
local accumulation; PTC call = 1 step, each partial-product accumulation
stage = 1 step, Hadamard = 1 step):

    T_fwd  = n_cols · (1 + Q)            (Q-deep partial-sum chain)
    T_∇Σ   = α_C·n_cols · 3              (2 parallel PTC passes + Hadamard,
                                          local accumulation pipelined)
    T_∇x   = n_cols · (1 + L_max)        (L_max = LONGEST accumulation path
                                          over rows of the masked W^T — the
                                          Fig-7 load-balance bottleneck
                                          btopk equalizes)

Only the RATIOS are meaningful (the paper's units are normalized too);
``sampling_table2`` reports totals in G-calls to match Table 2's scale.
Note on α conventions: our ``SparsityConfig`` stores KEEP densities;
the paper's table annotations quote drop sparsities (their α=0.6 row
means keep 0.4 — verified against Table 2's 8.34→3.38 ∇x energy).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from .sparsity import SparsityConfig

__all__ = ["LayerCost", "ModelCost", "LayerSpec", "layer_cost", "model_cost",
           "conv_layer_spec", "linear_layer_spec", "vgg8_specs",
           "resnet18_specs"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Shape of one PTC-mapped projection for costing purposes."""

    name: str
    c_out: int          # output channels / features (M)
    c_in_eff: int       # input channels × K² (N after im2col)
    n_cols: int         # streamed columns: B·H'·W' (conv) or B·T (LM)
    k: int = 9          # PTC block size
    first_layer: bool = False   # no ∇x needed into the data

    @property
    def grid(self) -> tuple[int, int]:
        p = -(-self.c_out // self.k)
        q = -(-self.c_in_eff // self.k)
        return p, q


def conv_layer_spec(name, c_out, c_in, ksize, batch, h_out, w_out, k=9,
                    first_layer=False) -> LayerSpec:
    return LayerSpec(name=name, c_out=c_out, c_in_eff=c_in * ksize * ksize,
                     n_cols=batch * h_out * w_out, k=k,
                     first_layer=first_layer)


def linear_layer_spec(name, d_out, d_in, n_tokens, k=9,
                      first_layer=False) -> LayerSpec:
    return LayerSpec(name=name, c_out=d_out, c_in_eff=d_in,
                     n_cols=n_tokens, k=k, first_layer=first_layer)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    e_fwd: float
    e_bwd_w: float
    e_bwd_x: float
    t_fwd: float
    t_bwd_w: float
    t_bwd_x: float

    @property
    def e_total(self) -> float:
        return self.e_fwd + self.e_bwd_w + self.e_bwd_x

    @property
    def t_total(self) -> float:
        return self.t_fwd + self.t_bwd_w + self.t_bwd_x

    def __add__(self, other: "LayerCost") -> "LayerCost":
        return LayerCost(*(a + b for a, b in
                           zip(dataclasses.astuple(self),
                               dataclasses.astuple(other))))


ModelCost = LayerCost  # an aggregate is structurally identical


def layer_cost(spec: LayerSpec, cfg: SparsityConfig,
               max_path: int | None = None,
               inference_only: bool = False) -> LayerCost:
    """Cost one optimization iteration of one layer under sampling ``cfg``.

    ``max_path``: longest per-row kept-block count of the feedback mask
    (defaults to the balanced value ⌈α_W·P⌉ — btopk guarantees it; pass
    the measured value for topk to expose its load imbalance).
    """
    p, q = spec.grid
    n = spec.n_cols
    keep_w = max(1, int(round(cfg.alpha_w * p))) if cfg.alpha_w < 1.0 else p
    kept_cols = max(1, int(round(cfg.alpha_c * n))) if cfg.alpha_c < 1.0 else n
    run_frac = 1.0 - cfg.alpha_d    # SMD skips whole iterations

    e_fwd = float(p * q * n)
    if inference_only:
        return LayerCost(e_fwd, 0.0, 0.0, float(n * (1 + q)), 0.0, 0.0)

    e_bwd_w = 2.0 * p * q * kept_cols
    e_bwd_x = 0.0 if spec.first_layer else float(keep_w * q * n)

    if max_path is None:
        max_path = keep_w
    t_fwd = float(n * (1 + q))
    t_bwd_w = float(kept_cols * 3)
    t_bwd_x = 0.0 if spec.first_layer else float(n * (1 + max_path))

    return LayerCost(e_fwd * run_frac, e_bwd_w * run_frac, e_bwd_x * run_frac,
                     t_fwd * run_frac, t_bwd_w * run_frac, t_bwd_x * run_frac)


def model_cost(specs: Iterable[LayerSpec], cfg: SparsityConfig,
               iters: float = 1.0, **kw) -> LayerCost:
    total = LayerCost(0, 0, 0, 0, 0, 0)
    for s in specs:
        total = total + layer_cost(s, cfg, **kw)
    return LayerCost(*(x * iters for x in dataclasses.astuple(total)))


# -- reference model layer stacks (paper §4.1) ------------------------------


def vgg8_specs(batch: int = 128, k: int = 9) -> list[LayerSpec]:
    """VGG-8 on CIFAR-10 (32×32): conv stack + FC head."""
    cfg = [(64, 3, 32), (64, 64, 16), (128, 64, 16), (128, 128, 8),
           (256, 128, 8), (256, 256, 4)]
    specs = []
    c_prev = None
    for i, (c_out, c_in, hw) in enumerate(cfg):
        specs.append(conv_layer_spec(f"conv{i}", c_out, c_in, 3, batch, hw, hw,
                                     k=k, first_layer=(i == 0)))
    specs.append(linear_layer_spec("fc1", 512, 256 * 4 * 4 // 4, batch, k=k))
    specs.append(linear_layer_spec("fc2", 10, 512, batch, k=k))
    return specs


def resnet18_specs(batch: int = 128, k: int = 9) -> list[LayerSpec]:
    """ResNet-18 (CIFAR variant, 32×32 stem)."""
    specs = [conv_layer_spec("stem", 64, 3, 3, batch, 32, 32, k=k,
                             first_layer=True)]
    plan = [(64, 32, 2), (128, 16, 2), (256, 8, 2), (512, 4, 2)]
    c_in = 64
    for c_out, hw, blocks in plan:
        for b in range(blocks):
            specs.append(conv_layer_spec(f"c{c_out}b{b}a", c_out, c_in, 3,
                                         batch, hw, hw, k=k))
            specs.append(conv_layer_spec(f"c{c_out}b{b}b", c_out, c_out, 3,
                                         batch, hw, hw, k=k))
            c_in = c_out
    specs.append(linear_layer_spec("fc", 10, 512, batch, k=k))
    return specs
