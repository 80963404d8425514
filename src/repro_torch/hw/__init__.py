"""Hardware control plane: one observability boundary (PyTorch port).

Counterpart of ``repro/hw``: the :class:`PhotonicDriver` ABC with its
PTC-call meter, and the in-process :class:`TwinDriver` (without drift in
this slice).  Control-plane code (``core.calibration``, ``core.mapping``)
reaches the device only through these.
"""

from .driver import (PhotonicDriver, DriverStats, ZORefineResult,
                     ICJobResult, probe_cost, readback_cost,
                     readout_blocks, resolve_block_range)
from .twin import TwinDriver, make_twin  # repro: noqa[RPL101]

__all__ = ["PhotonicDriver", "DriverStats", "ZORefineResult", "ICJobResult",
           "probe_cost", "readback_cost", "readout_blocks",
           "resolve_block_range", "TwinDriver", "make_twin"]
