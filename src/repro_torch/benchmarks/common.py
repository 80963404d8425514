"""Shared benchmark utilities: CSV emission, a device-synchronized timer,
and the host-side random draws the tables hand to the device.

Counterpart of ``benchmarks/common.py``; the port writes its tables under
``bench_artifacts/torch/`` so they can never overwrite the reference's.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from ..optim.zo import zo_draws

__all__ = ["ART", "emit", "Timer", "cpu_generator", "zo_draws", "to_device"]

ART = Path(__file__).resolve().parents[3] / "bench_artifacts" / "torch"


def emit(name: str, header: list[str], rows: list[list]) -> Path:
    """Write ``rows`` under ``header`` to ``ART/<name>.csv`` and print them."""
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / f"{name}.csv"
    lines = [",".join(header)] + [",".join(str(x) for x in r) for r in rows]
    text = "\n".join(lines)
    path.write_text(text + "\n")
    print(f"--- {name} ---")
    print(text, flush=True)
    return path


class Timer:
    """Host wall seconds of a ``with`` block (``dt``); on a CUDA device the
    card is synchronized before each clock read, so ``dt`` covers the
    block's device work."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device(device) if device is not None else None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._sync()
        self.dt = time.perf_counter() - self.t0


def cpu_generator(seed: int) -> torch.Generator:
    """The tables' source of randomness: a CPU generator, whatever the
    device the tables run on."""
    return torch.Generator("cpu").manual_seed(seed)


def to_device(tree, device):
    """Every tensor of nested tuples, NamedTuples, lists and dicts moved to
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {key: to_device(val, device) for key, val in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(val, device) for val in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(val, device) for val in tree)
    return tree
