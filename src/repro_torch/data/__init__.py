"""Deterministic synthetic data pipelines (numpy; no external datasets:
the tasks are built to be learnable, so training shows real loss
curves)."""

from .synthetic import (  # noqa: F401
    lm_batch, lm_batch_stream, synthetic_vision, vision_stream,
    vowel_stream, transfer_vision,
)
