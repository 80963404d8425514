"""Hardware control plane: one observability boundary (PyTorch port).

Counterpart of ``repro/hw``: the :class:`PhotonicDriver` ABC with its
PTC-call meter and batched op lists, the in-process :class:`TwinDriver`
with its OU drift walk, and :func:`make_driver`.  Control-plane code
(``core.calibration``, ``core.mapping``, ``runtime``) reaches the device
only through these; twin readouts only through ``driver.unsafe_twin()``.
The reference's stream transports (subprocess, socket) are not ported.
"""

from .driver import (PhotonicDriver, DriverStats, ZORefineResult,
                     ICJobResult, TwinUnavailable, CompletedBatch,
                     probe_cost, readback_cost, readout_blocks,
                     resolve_block_range)
from .drift import (DriftConfig, DriftState, init_drift, advance,  # repro: noqa[RPL101]
                    bias_deviation, DEFAULT_DRIFT)
from .twin import TwinDriver, TwinHandle, make_twin  # repro: noqa[RPL101]

__all__ = ["PhotonicDriver", "DriverStats", "ZORefineResult", "ICJobResult",
           "TwinUnavailable", "CompletedBatch", "probe_cost",
           "readback_cost", "readout_blocks", "resolve_block_range",
           "DriftConfig", "DriftState", "init_drift", "advance",
           "bias_deviation", "DEFAULT_DRIFT", "TwinDriver", "TwinHandle",
           "make_twin", "make_driver"]


def make_driver(transport: str, gen, n_blocks: int, k: int, model,
                kind: str = "clements", *, m: int | None = None,
                n: int | None = None, drift=None,
                device=None) -> PhotonicDriver:
    """Uniform driver factory.  ``transport`` ``"twin"`` builds an
    in-process :class:`TwinDriver` on ``device``; the reference's
    ``"subprocess"`` and ``"socket"`` transports are not ported."""
    if transport == "twin":
        return make_twin(gen, n_blocks, k, model, kind, m=m, n=n,
                         drift=drift, device=device)
    if transport in ("subprocess", "socket"):
        raise ValueError(
            f"driver transport {transport!r} is not ported: the stream "
            f"transports are the driver plane (ROADMAP queue 1, item 7)")
    raise ValueError(f"unknown driver transport: {transport!r}")
