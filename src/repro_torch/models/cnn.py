"""The paper's own evaluation models: MLP / CNN-S / CNN-L / VGG-8 (§4.1).

Counterpart of ``repro/models/cnn.py``.  Convolutions are im2col'd and fed
through k = 9 PTC linears (the paper's fully parallel 9×9-blocking matrix
multiplication); the im2col columns are what column sampling drops.
Activations stay NHWC, as in the reference, so flattened features and
im2col features come in the same order in both packages: (C, KH, KW) per
patch, (H, W, C) before the classifier.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..core.ptc import PTCParams
from ..core.sparsity import SparsityConfig
from ..core.subspace import SubspaceMasks, sample_masks
from .layers import (PTCLinearCfg, apply_ptc_linear, init_ptc_linear,
                     trainable_mask)

__all__ = ["ConvSpec", "FCSpec", "PoolSpec", "CNNConfig", "init_cnn",
           "cnn_masks", "cnn_forward", "build_cnn_train_step", "MLP_VOWEL",
           "CNN_S", "CNN_L", "VGG8"]

Params = dict


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    c_out: int
    ksize: int = 3
    stride: int = 1
    pad: str = "SAME"


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    size: int
    kind: str = "avg"    # avg | max


@dataclasses.dataclass(frozen=True)
class FCSpec:
    d_out: int


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    layers: tuple
    in_shape: tuple          # (H, W, C) images or (D,) flat features
    n_classes: int
    ptc: PTCLinearCfg = dataclasses.field(
        default_factory=lambda: PTCLinearCfg(k=9, mode="blocked",
                                             base_dtype=torch.float32))


# paper §4.1 model zoo
MLP_VOWEL = CNNConfig("mlp-vowel", (FCSpec(16), FCSpec(16), FCSpec(4)),
                      in_shape=(8,), n_classes=4)
CNN_S = CNNConfig("cnn-s", (ConvSpec(8, 3, 2), ConvSpec(6, 3, 2), FCSpec(10)),
                  in_shape=(28, 28, 1), n_classes=10)
CNN_L = CNNConfig("cnn-l", (ConvSpec(64), ConvSpec(64), ConvSpec(64),
                            PoolSpec(5), FCSpec(10)),
                  in_shape=(28, 28, 1), n_classes=10)
VGG8 = CNNConfig("vgg8", (ConvSpec(64), ConvSpec(64), PoolSpec(2),
                          ConvSpec(128), ConvSpec(128), PoolSpec(2),
                          ConvSpec(256), ConvSpec(256), PoolSpec(2),
                          FCSpec(512), FCSpec(10)),
                 in_shape=(32, 32, 3), n_classes=10)


def _same_pads(n: int, ksize: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding: the odd extra row/column goes after."""
    total = max((-(-n // stride) - 1) * stride + ksize - n, 0)
    return total // 2, total - total // 2


def _im2col(x: torch.Tensor, ksize: int, stride: int, pad: str
            ) -> torch.Tensor:
    """(B, H, W, C) → (B, H', W', C·K·K) patches, features ordered
    (C, KH, KW) as ``conv_general_dilated_patches`` orders them."""
    b, h, w, c = x.shape
    xc = x.permute(0, 3, 1, 2)
    if pad == "SAME":
        top, bottom = _same_pads(h, ksize, stride)
        left, right = _same_pads(w, ksize, stride)
        xc = F.pad(xc, (left, right, top, bottom))
    elif pad != "VALID":
        raise ValueError(f"unknown padding: {pad!r}")
    ho = (xc.shape[2] - ksize) // stride + 1
    wo = (xc.shape[3] - ksize) // stride + 1
    cols = F.unfold(xc, ksize, stride=stride)           # (B, C·K·K, H'·W')
    return cols.transpose(1, 2).reshape(b, ho, wo, c * ksize * ksize)


def _walk(cfg: CNNConfig):
    """(index, spec, input shape, output shape) of every layer."""
    shape = cfg.in_shape
    for i, spec in enumerate(cfg.layers):
        if isinstance(spec, ConvSpec):
            h, w, _ = shape
            s = spec.stride
            if spec.pad == "SAME":
                h, w = -(-h // s), -(-w // s)
            else:
                h, w = (h - spec.ksize) // s + 1, (w - spec.ksize) // s + 1
            out = (h, w, spec.c_out)
        elif isinstance(spec, PoolSpec):
            h, w, c = shape
            out = (h // spec.size, w // spec.size, c)
        else:
            out = (spec.d_out,)
        yield i, spec, shape, out
        shape = out


def init_cnn(gen: torch.Generator, cfg: CNNConfig) -> Params:
    """Random PTC parameters (with biases) for every conv / FC layer, on
    the generator's device."""
    params: Params = {}
    for i, spec, shape, _ in _walk(cfg):
        if isinstance(spec, ConvSpec):
            d_in = shape[2] * spec.ksize * spec.ksize
            params[f"l{i}"] = init_ptc_linear(gen, d_in, spec.c_out, cfg.ptc,
                                              bias=True)
        elif isinstance(spec, FCSpec):
            d_in = 1
            for n in shape:
                d_in *= n
            params[f"l{i}"] = init_ptc_linear(gen, d_in, spec.d_out, cfg.ptc,
                                              bias=True)
    return params


def _layer_masks(p: Params, gen: torch.Generator,
                 sparsity: SparsityConfig | None, n_cols: int
                 ) -> SubspaceMasks | None:
    """Feedback + column masks sized to THIS layer's grid and THIS layer's
    im2col column count (the paper's column sampling is per layer)."""
    if sparsity is None or not sparsity.enabled or "s" not in p:
        return None
    return sample_masks(gen, PTCParams(p["u"], p["s"], p["v"]), n_cols,
                        sparsity)


def cnn_masks(params: Params, cfg: CNNConfig, batch: int,
              gen: torch.Generator, sparsity: SparsityConfig | None
              ) -> dict[str, SubspaceMasks | None]:
    """One step's masks for every PTC layer, drawn in layer order."""
    masks = {}
    for i, spec, _, out in _walk(cfg):
        if isinstance(spec, ConvSpec):
            n_cols = batch * out[0] * out[1]
        elif isinstance(spec, FCSpec):
            n_cols = batch
        else:
            continue
        masks[f"l{i}"] = _layer_masks(params[f"l{i}"], gen, sparsity, n_cols)
    return masks


def cnn_forward(params: Params, cfg: CNNConfig, x: torch.Tensor,
                masks: dict[str, SubspaceMasks | None] | None = None
                ) -> torch.Tensor:
    """x: (B, H, W, C) or (B, D) → logits (B, n_classes)."""
    masks = masks or {}
    n = len(cfg.layers)
    for i, spec in enumerate(cfg.layers):
        name = f"l{i}"
        if isinstance(spec, ConvSpec):
            cols = _im2col(x, spec.ksize, spec.stride, spec.pad)
            b, h, w, d = cols.shape
            y = apply_ptc_linear(params[name], cols.reshape(b, h * w, d),
                                 cfg.ptc, masks.get(name), d_out=spec.c_out)
            x = torch.relu(y.reshape(b, h, w, spec.c_out))
        elif isinstance(spec, PoolSpec):
            b, h, w, c = x.shape
            s = spec.size
            xr = x[:, : h // s * s, : w // s * s].reshape(
                b, h // s, s, w // s, s, c)
            x = xr.amax((2, 4)) if spec.kind == "max" else xr.mean((2, 4))
        else:
            if x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            x = apply_ptc_linear(params[name], x, cfg.ptc, masks.get(name),
                                 d_out=spec.d_out)
            if i < n - 1:
                x = torch.relu(x)
    return x


def build_cnn_train_step(cfg: CNNConfig,
                         sparsity: SparsityConfig | None = None):
    """``train_step(params, batch{x, y}, gen=None, masks=None) → (loss,
    grads)`` with the paper's multi-level sampled in-situ gradients.

    Masks are drawn from ``gen`` (:func:`cnn_masks`) unless ``masks`` is
    given; with neither, the gradients are dense.  ``grads`` holds the
    trainable leaves only (:func:`~.layers.trainable_mask`: Σ and biases),
    in ``params``' nesting.
    """

    def train_step(params: Params, batch: dict, gen=None, masks=None):
        x, y = batch["x"], batch["y"]
        if masks is None and gen is not None:
            masks = cnn_masks(params, cfg, x.shape[0], gen, sparsity)
        tr = trainable_mask(params)
        live = {name: {leaf: a.detach().requires_grad_() if tr[name][leaf]
                       else a for leaf, a in layer.items()}
                for name, layer in params.items()}
        loss = F.cross_entropy(cnn_forward(live, cfg, x, masks).float(),
                               y.long())
        keys = [(name, leaf) for name, layer in live.items()
                for leaf in layer if tr[name][leaf]]
        grads: Params = {}
        for (name, leaf), g in zip(keys, torch.autograd.grad(
                loss, [live[name][leaf] for name, leaf in keys])):
            grads.setdefault(name, {})[leaf] = g
        return loss.detach(), grads

    return train_step
