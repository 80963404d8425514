"""PyTorch + CUDA port of the L2ight reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
``core/ hw/ optim/ data/ kernels/`` layout and module names so each
counterpart is easy to find.  It imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``repro``; what it needs from the reference's
pure-numpy modules it carries as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`).  On a CUDA tensor every
kernel wrapper launches its hand-written Hopper kernel
(``repro_torch/csrc``); on a CPU tensor it runs the plain PyTorch version.
"""

import torch

from .device import resolve_device

# PM's distances and OSP are fp32 checks that TF32 (about three decimal
# digits) would break: pin full-precision fp32 products explicitly.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
