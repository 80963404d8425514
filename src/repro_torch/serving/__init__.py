"""Continuous-batching serving gateway, counterpart of ``repro.serving``:
a FIFO admission scheduler (``scheduler``) batches concurrent decode
streams into one model forward per step over a paged KV cache
(``kv_pages`` + ``kernels.paged_kv``), with chunked prefill through
``kernels.prefill_attention`` (``engine``), digitally or through the
hardware-in-the-loop plane (``build_gateway_hw_plane``).

    python -m repro_torch.serving.gateway --arch smoke:qwen3-4b \\
        --device cpu --prefill-chunk 4
"""

from .engine import GatewayConfig, ServingGateway, build_gateway_hw_plane
from .kv_pages import PageConfig, PagedKVPool
from .scheduler import Request, Scheduler, poisson_workload

__all__ = ["PageConfig", "PagedKVPool", "Request", "Scheduler",
           "poisson_workload", "GatewayConfig", "ServingGateway",
           "build_gateway_hw_plane"]
