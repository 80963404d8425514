"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` unless the caller asks for another device.

    Without a CUDA device this raises instead of falling back to the CPU:
    a run that was meant for the card must never quietly measure the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the host")
    return dev
