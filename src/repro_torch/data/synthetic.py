"""Synthetic, deterministic, learnable datasets (numpy).

Copied from ``repro/data/synthetic.py``: an order-1 Markov token stream
with a fixed random transition table (``lm_batch``, ``lm_batch_stream``),
class-templated inputs plus Gaussian noise (``synthetic_vision``,
``vision_stream``), a related transfer task whose class templates are
mixes of the first task's (``transfer_vision``, the paper's Fig. 14) and
the Vowel MLP's 8-feature 4-class blobs (``vowel_stream``).  Every batch is
a pure function of (seed, step), so the port and the reference see the
same data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lm_batch", "lm_batch_stream", "synthetic_vision",
           "vision_stream", "vowel_stream", "transfer_vision"]


def _markov_table(vocab: int, seed: int = 0, branch: int = 4) -> np.ndarray:
    """(vocab, branch) table: each context allows `branch` next tokens."""
    rng = np.random.default_rng(seed)
    table = np.zeros((vocab, branch), dtype=np.int64)
    for c in range(vocab):
        table[c] = rng.choice(vocab, size=branch, replace=False)
    return table


_TABLES: dict = {}


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int
             ) -> dict[str, np.ndarray]:
    """One (tokens, labels) LM batch — order-1 Markov with 4-way branching."""
    key = (vocab, seed)
    if key not in _TABLES:
        _TABLES[key] = _markov_table(vocab, seed)
    table = _TABLES[key]
    rng = np.random.default_rng((seed + 1) * 1_000_003 + step)
    toks = np.empty((batch, seq + 1), dtype=np.int32)
    toks[:, 0] = rng.integers(0, vocab, batch)
    choices = rng.integers(0, table.shape[1], (batch, seq))
    for t in range(seq):
        toks[:, t + 1] = table[toks[:, t], choices[:, t]]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_batch_stream(seed: int, batch: int, seq: int, vocab: int, steps: int):
    for step in range(steps):
        yield lm_batch(seed, step, batch, seq, vocab)


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


def vision_stream(seed: int, batch: int, shape: tuple, n_classes: int,
                  steps: int, **kw):
    for step in range(steps):
        yield synthetic_vision(seed, step, batch, shape, n_classes, **kw)


def transfer_vision(seed: int, step: int, batch: int, shape: tuple,
                    n_classes: int, noise: float = 1.0):
    return synthetic_vision(seed, step, batch, shape, n_classes, noise,
                            rot_classes=True)


def vowel_stream(seed: int, batch: int, steps: int):
    """8-feature 4-class Gaussian blobs (the paper's Vowel MLP task)."""
    for step in range(steps):
        yield synthetic_vision(seed, step, batch, (8,), 4, noise=0.6)
