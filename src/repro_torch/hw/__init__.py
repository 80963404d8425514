"""Hardware control plane: one observability boundary (PyTorch port).

Counterpart of ``repro/hw``.  Control-plane code (``core.calibration``,
``core.mapping``, ``runtime``) reaches a device only through the
:class:`PhotonicDriver` ABC, with its PTC-call meter and batched op lists;
twin readouts only through ``driver.unsafe_twin()``.

    hw/driver.py             the ABC, the PTC-call meter, the wire key
    hw/twin.py               the in-process digital twin (+ hw/drift.py)
    hw/protocol.py           the wire codec: v3 JSON lines, v4 binary frames
    hw/server.py             the device server (``python -m
                             repro_torch.hw.server``, stdio or TCP)
    hw/stream_driver.py      the shared op-stream client (pipelined writes,
                             batch frames, the async reader)
    hw/subprocess_driver.py  pipe transport (a server child)
    hw/socket_driver.py      TCP transport (a loopback child or a daemon)
    hw/instrument_driver.py  a real instrument's skeleton (the ABC minus
                             ``unsafe_twin``)

Three transports: :class:`TwinDriver` in process, and
:class:`SubprocessDriver` / :class:`SocketDriver` over the wire of
``docs/wire-protocol.md``, which the reference's clients and servers speak
too.  For one generator the three give the same bits and the same meter.

The ``# repro: noqa[RPL1xx]`` tags on this package's lines (and on
``convert.py``, ``runtime/fleet.py`` and ``chip_smoke.py``) are for the
reference's checker, which scans all of ``src`` and reads the port with
its own module map; the port's checker (``repro_torch.analysis``, rules
RPT1xx) reads them clean without a tag and ignores that one.
"""

from .driver import (PhotonicDriver, DriverStats, ZORefineResult,
                     ICJobResult, TwinUnavailable, CompletedBatch,
                     probe_cost, readback_cost, readout_blocks,
                     resolve_block_range, wire_key, key_generator)
from .drift import (DriftConfig, DriftState, init_drift, advance,  # repro: noqa[RPL101]
                    bias_deviation, DEFAULT_DRIFT)
from .protocol import (PROTOCOL_VERSION, SUPPORTED_VERSIONS,
                       MAX_FRAME_BYTES)
from .twin import TwinDriver, TwinHandle, make_twin  # repro: noqa[RPL101]
from .stream_driver import StreamDriver, BatchFuture
from .subprocess_driver import SubprocessDriver
from .socket_driver import SocketDriver
from .instrument_driver import ReferenceInstrumentDriver

__all__ = ["PhotonicDriver", "DriverStats", "ZORefineResult", "ICJobResult",
           "TwinUnavailable", "CompletedBatch", "probe_cost",
           "readback_cost", "readout_blocks", "resolve_block_range",
           "wire_key", "key_generator", "PROTOCOL_VERSION",
           "SUPPORTED_VERSIONS", "MAX_FRAME_BYTES",
           "DriftConfig", "DriftState", "init_drift", "advance",
           "bias_deviation", "DEFAULT_DRIFT", "TwinDriver", "TwinHandle",
           "make_twin", "StreamDriver", "BatchFuture", "SubprocessDriver",
           "SocketDriver", "ReferenceInstrumentDriver", "make_driver"]


def make_driver(transport: str, gen, n_blocks: int, k: int, model,
                kind: str = "clements", *, m: int | None = None,
                n: int | None = None, drift=None, device=None,
                address: tuple[str, int] | None = None,
                protocol: int | None = None) -> PhotonicDriver:
    """Uniform driver factory: ``transport`` ∈ {"twin", "subprocess",
    "socket"}.

    Every transport draws one construction key from ``gen``
    (:func:`wire_key`) and samples its twin from :func:`key_generator` of
    it, in process or in the server, then moves it to ``device`` (``cuda``
    by default): one generator gives one realization and one drift chain on
    all three, on the CPU and on the card.  ``address=(host, port)`` points
    the socket transport at a running ``repro_torch.hw.server --socket``
    daemon (its own ``--device`` applies there); without it the socket
    driver self-hosts a loopback server child.  ``protocol`` pins the
    stream transports to wire v3 or v4 instead of negotiating v4 with a v3
    fallback."""
    if transport not in ("twin", "subprocess", "socket"):
        raise ValueError(f"unknown driver transport: {transport!r}")
    key = wire_key(gen)
    if transport == "twin":
        return make_twin(key_generator(key), n_blocks, k, model, kind, m=m,
                         n=n, drift=drift, device=device)
    if transport == "subprocess":
        return SubprocessDriver(key, n_blocks, k, model, kind, m=m, n=n,
                                drift=drift, device=device, protocol=protocol)
    return SocketDriver(key, n_blocks, k, model, kind, m=m, n=n,
                        drift=drift, address=address, device=device,
                        protocol=protocol)
