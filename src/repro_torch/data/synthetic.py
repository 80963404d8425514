"""Synthetic, deterministic, learnable datasets (numpy).

Copied from ``repro/data/synthetic.py`` (``synthetic_vision`` only):
class-templated inputs plus Gaussian noise, a pure function of
(seed, step), so the port and the reference see the same data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synthetic_vision"]


def _templates(n_classes: int, shape: tuple, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_classes,) + shape).astype(np.float32)


def synthetic_vision(seed: int, step: int, batch: int, shape: tuple,
                     n_classes: int, noise: float = 1.0,
                     rot_classes: bool = False) -> dict[str, np.ndarray]:
    """Class-template + Gaussian-noise images; ``rot_classes`` derives a
    RELATED transfer task: the class templates are permuted and
    perturbed, so the feature subspace is shared but the readout must be
    re-learned (the CIFAR-100→CIFAR-10 analogue of Fig. 14)."""
    tpl = _templates(n_classes, shape, seed)
    if rot_classes:
        # task B's classes are linear mixes of task A's templates — the
        # FEATURE SUBSPACE is shared (as in CIFAR-100→10), only the
        # class readout differs, which is what Σ-only adaptation can do
        rng_t = np.random.default_rng(seed + 77)
        mix = rng_t.standard_normal((n_classes, n_classes)).astype(
            np.float32)
        mix, _ = np.linalg.qr(mix)
        flat = tpl.reshape(n_classes, -1)
        tpl = (mix @ flat).reshape(tpl.shape) * 1.0
    rng = np.random.default_rng((seed + 2) * 999_983 + step)
    y = rng.integers(0, n_classes, batch).astype(np.int32)
    x = tpl[y] + noise * rng.standard_normal((batch,) + shape).astype(
        np.float32)
    return {"x": x, "y": y}
