"""Hand-written Hopper kernels of the port and their plain versions.

============================  ==========================================
wrapper                       replaces (TPU kernel in ``repro.kernels``)
============================  ==========================================
``ptc_block_matmul``          ``ptc_block_matmul.ptc_block_matmul``
``mesh_apply(_batched)``      ``mesh_apply.mesh_apply_butterfly``
``sigma_grad``                ``sigma_grad.sigma_grad``
``feedback_matmul``           ``feedback_matmul.feedback_matmul``
``paged_gather``              ``paged_kv.paged_gather``
``paged_scatter(_rows)``      ``paged_kv.paged_scatter(_rows)``
``prefill_attention``         ``prefill_attn.prefill_attention``
============================  ==========================================

``prefill_attention`` has two kernels: the tensor-core one for bf16 q over
bf16 K/V at head dims 64 and 128, the CUDA-core one for every other pair
(:func:`.prefill_attn.route`).  ``ptc_block_matmul`` has two routes: the
per-block one for one input block and few rows (the IC/PM probes), the
product one for every other shape (:func:`.ptc_block_matmul.route`).
Past k = 32 the PTC and mesh wrappers take wide routes, and the three PTC
wrappers take bf16 operands at k 64 and 128 to the tensor cores
(``"wide_tc"``), and the forward and Σ-gradient take fp32 operands there
to the tensor cores in 3xTF32 (``"wide_3xtf32"``; each ``route`` reads
the dtype).

Each wrapper launches its CUDA kernel (``repro_torch/csrc``) on a CUDA
tensor and runs its plain PyTorch version (:mod:`.ref`) on a CPU tensor.
"""

from .build import launch_counts, reset_launch_counts
from .feedback_matmul import feedback_matmul
from .mesh_apply import mesh_apply, mesh_apply_batched, mesh_apply_plain
from .paged_kv import paged_gather, paged_scatter, paged_scatter_rows
from .prefill_attn import prefill_attention
from .ptc_block_matmul import ptc_block_matmul
from .sigma_grad import sigma_grad

__all__ = ["launch_counts", "reset_launch_counts", "mesh_apply",
           "mesh_apply_batched", "mesh_apply_plain", "ptc_block_matmul",
           "sigma_grad", "feedback_matmul", "paged_gather", "paged_scatter",
           "paged_scatter_rows", "prefill_attention"]
