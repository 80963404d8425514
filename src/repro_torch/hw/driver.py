"""`PhotonicDriver`: the single observability boundary to a device.

Counterpart of ``repro/hw/driver.py``.  On chip only the end-to-end
``UΣV*`` response is observable, so the control plane (IC, PM, the
closed-loop runtime) talks to a device only through this ABC:

================  =========================================================
op                physical meaning
================  =========================================================
write_phases      command the MZI rotation phases Φ^U / Φ^V
write_sigma       command the Σ attenuators
write_signs       command the ±1 crossing configuration (topological)
read_phases/...   read back the *commanded* state (controller-known)
forward           stream probe columns through the realized UΣV* response
forward_layer     serve-path forward through the assembled P×Q block grid
readback_bases    reciprocal-probe readout of the realized bases (OSP)
zo_refine         in-situ job: hardware-restricted ZCD on Φ
run_ic            in-situ job: Identity Calibration's surrogate search
advance           let (virtual) time pass
================  =========================================================

Every op that touches light is metered in :class:`DriverStats` in the
paper's Appendix-G unit (PTC calls), exactly as the reference charges it.

Batched op lists
----------------
Every driver also executes an ordered op list via :meth:`run_batch`
(``[(op_name, kwargs), ...]`` → per-op results), ops in list order, each
metered on its own, so batched and sequential encodings give the same
bits.  :meth:`run_batch_async` hands back a future-like handle; an
in-process driver has no round trip to overlap, so it resolves at once.
Twin-only readouts are reachable only through :meth:`unsafe_twin`.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DriverStats", "PhotonicDriver", "ZORefineResult", "ICJobResult",
           "TwinUnavailable", "CompletedBatch", "probe_cost",
           "readback_cost", "readout_blocks", "resolve_block_range",
           "BATCHABLE_OPS", "WIRE_INTERNAL_OPS", "STAT_CATEGORIES",
           "forward_coalesce_key", "coalesce_spans", "validate_batch_ops",
           "wire_key", "key_generator"]

# the PTC meter's categories (DriverStats fields a charge may land in)
STAT_CATEGORIES = frozenset(["serve", "probe", "readback", "search"])

# the op surface a batched list may carry (the reference's wire protocol's
# dispatchable set); lifecycle ops (``close``, ``unsafe_twin``) are not
BATCHABLE_OPS = frozenset([
    "write_phases", "write_sigma", "write_signs", "read_phases",
    "read_sigma", "forward", "forward_layer", "readback_bases",
    "zo_refine", "run_ic", "advance", "charge", "reset_stats", "stats",
])

# ops that exist only inside a wire batch frame of the reference's stream
# transports (a coalesced span of ``forward`` ops); never in a user list
WIRE_INTERNAL_OPS = frozenset(["forward_many"])


def forward_coalesce_key(kw: dict):
    """Coalescibility key of a batched ``forward`` op: consecutive forwards
    merge only when probe shape, metering category and tenant scope all
    agree."""
    br = kw.get("block_range")
    x = kw.get("x")
    shape = getattr(x, "shape", None)
    return (tuple(shape) if shape is not None else np.shape(x),
            kw.get("category", "probe"),
            None if br is None else (int(br[0]), int(br[1])))


def coalesce_spans(keys: list) -> "list[tuple[int, int]]":
    """``[start, stop)`` spans of an op list, merging runs of equal
    consecutive non-None keys."""
    spans = []
    i = 0
    while i < len(keys):
        j = i
        while (keys[i] is not None and j + 1 < len(keys)
               and keys[j + 1] == keys[i]):
            j += 1
        spans.append((i, j + 1))
        i = j + 1
    return spans


def validate_batch_ops(ops) -> None:
    """Reject a batched op list before executing any of it."""
    for name, kw in ops:
        if name not in BATCHABLE_OPS:
            raise ValueError(f"op {name!r} cannot appear inside a batch")
        if kw.get("category") is not None \
                and kw["category"] not in STAT_CATEGORIES:
            raise ValueError(
                f"{name}: unknown PTC-meter category "
                f"{kw['category']!r} (one of {sorted(STAT_CATEGORIES)})")


def wire_key(gen: torch.Generator) -> np.ndarray:
    """One construction key drawn from ``gen``: two uint32 words, shaped
    like a raw ``jax.random`` key, so it rides the wire's ``init`` frame
    to either package's server.  Every transport of :func:`make_driver`
    draws it, so they consume ``gen`` alike."""
    words = torch.randint(0, 2 ** 32, (2,), generator=gen, device=gen.device,
                          dtype=torch.int64)
    return words.cpu().numpy().astype(np.uint32)


def key_generator(key) -> torch.Generator:
    """The CPU generator a twin samples from for a wire key: seeded by the
    key's two uint32 words as one 64-bit integer, so one key gives one
    realization on every device and in every process."""
    hi, lo = (int(w) for w in np.asarray(key, dtype=np.uint32).reshape(2))
    return torch.Generator("cpu").manual_seed((hi << 32) | lo)


class TwinUnavailable(RuntimeError):
    """The driver is not backed by an inspectable digital twin."""


def resolve_block_range(n_blocks: int,
                        block_range: tuple[int, int] | None
                        ) -> tuple[int, int]:
    """Validate a tenant block range against the chip geometry.

    ``None`` means the whole chip ``(0, n_blocks)``; otherwise the range
    must be a non-empty ``(start, stop)`` inside ``[0, n_blocks]``.
    """
    if block_range is None:
        return 0, n_blocks
    start, stop = int(block_range[0]), int(block_range[1])
    if not (0 <= start < stop <= n_blocks):
        raise ValueError(
            f"block_range {block_range!r} out of bounds for a chip with "
            f"{n_blocks} blocks")
    return start, stop


def probe_cost(n_blocks: int, n_cols: int) -> float:
    """PTC calls for ``n_cols`` probe columns through ``n_blocks`` blocks
    (Appendix-G: E_fwd = P·Q·n_cols with B = P·Q)."""
    return float(n_blocks * n_cols)


def readback_cost(n_blocks: int, k: int) -> float:
    """PTC calls for one reciprocal readback of the realized bases:
    two reciprocal passes of k columns per block (Claim 1)."""
    return float(2 * n_blocks * k)


def readout_blocks(driver: "PhotonicDriver", category: str = "probe",
                   block_range: tuple[int, int] | None = None
                   ) -> torch.Tensor:
    """Exact Ŵ readout, (B, k, k): k unit-vector probe columns per block
    — observability-legal (forward probes only), costs B·k PTC calls."""
    eye = torch.eye(driver.k, dtype=torch.float32, device=driver.device)
    y = driver.forward(eye, category=category, block_range=block_range)
    return y.transpose(1, 2)


@dataclasses.dataclass
class DriverStats:
    """PTC-call meter, split by control-plane purpose.

    ``serve``    — traffic through ``forward_layer``
    ``probe``    — health probes / observability reads (``forward``)
    ``readback`` — reciprocal basis readbacks (``readback_bases``)
    ``search``   — in-situ optimization jobs (``zo_refine`` / ``run_ic``)
    """

    serve: float = 0.0
    probe: float = 0.0
    readback: float = 0.0
    search: float = 0.0

    @property
    def total(self) -> float:
        return self.serve + self.probe + self.readback + self.search

    def as_dict(self) -> dict:
        return dict(serve=self.serve, probe=self.probe,
                    readback=self.readback, search=self.search,
                    total=self.total)

    def charge(self, category: str, calls: float) -> None:
        if category not in STAT_CATEGORIES:
            raise ValueError(
                f"unknown PTC-meter category {category!r} "
                f"(one of {sorted(STAT_CATEGORIES)})")
        setattr(self, category, getattr(self, category) + float(calls))


class ZORefineResult(NamedTuple):
    """Result of an in-situ ``zo_refine`` job (phases are also written)."""

    phi: torch.Tensor        # refreshed commanded phases, (B, 2T)
    loss: torch.Tensor       # final per-block objective values, (B,)
    history: torch.Tensor    # best-loss traces, (B, steps // record_every)
    steps: int               # ZCD probe steps actually spent per block


class ICJobResult(NamedTuple):
    """Result of an in-situ ``run_ic`` job (phases are also written)."""

    phi: torch.Tensor        # commanded phases after IC, (B, 2T)
    u: torch.Tensor          # readback of the realized Ĩ_U, (B, k, k)
    v: torch.Tensor          # readback of the realized Ĩ_V
    loss: torch.Tensor       # final surrogate loss per block
    history: torch.Tensor    # best-loss traces across restarts


class CompletedBatch:
    """Already-resolved future-like handle for :meth:`PhotonicDriver.
    run_batch_async` (``done()`` / ``result(timeout=None)``)."""

    def __init__(self, results: list):
        self._results = results

    def done(self) -> bool:
        return True

    def result(self, timeout=None) -> list:
        return self._results


class PhotonicDriver(abc.ABC):
    """Abstract control-plane handle to one photonic chip.

    A driver owns the commanded state (phases, attenuators, signs), the
    device's clock, and the PTC-call meter.  Writes, probes and jobs take
    an optional ``block_range=(start, stop)`` scoping them to one tenant's
    blocks.
    """

    # -- geometry (fixed at deployment) -------------------------------------

    @property
    @abc.abstractmethod
    def k(self) -> int:
        """PTC block size."""

    @property
    @abc.abstractmethod
    def kind(self) -> str:
        """Mesh topology (e.g. ``"clements"``)."""

    @property
    @abc.abstractmethod
    def n_blocks(self) -> int:
        """Number of independent k×k blocks on the chip."""

    @property
    @abc.abstractmethod
    def layer_shape(self) -> tuple[int, int]:
        """(M, N) of the logical weight the block grid assembles."""

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """Where the driver's tensors live (probe inputs go there too)."""

    # -- commanded state -----------------------------------------------------

    @abc.abstractmethod
    def write_phases(self, phi_u: torch.Tensor, phi_v: torch.Tensor, *,
                     block_range: tuple[int, int] | None = None) -> None:
        """Command the rotation phases, each (B, T)."""

    @abc.abstractmethod
    def write_sigma(self, sigma: torch.Tensor, *,
                    block_range: tuple[int, int] | None = None) -> None:
        """Command the Σ attenuators, (B, k)."""

    @abc.abstractmethod
    def write_signs(self, d_u: torch.Tensor, d_v: torch.Tensor, *,
                    block_range: tuple[int, int] | None = None) -> None:
        """Command the ±1 crossing configuration, each (B, k)."""

    @abc.abstractmethod
    def read_phases(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Commanded (Φ^U, Φ^V) — controller-known, free."""

    @abc.abstractmethod
    def read_sigma(self) -> torch.Tensor:
        """Commanded Σ — controller-known, free."""

    # -- observability-legal probes (metered) --------------------------------

    @abc.abstractmethod
    def forward(self, x: torch.Tensor, category: str = "probe", *,
                block_range: tuple[int, int] | None = None) -> torch.Tensor:
        """Stream shared probe columns ``x`` (n, k) through every block's
        realized response; returns (B, n, k).  Costs B·n PTC calls."""

    @abc.abstractmethod
    def forward_layer(self, x: torch.Tensor, *,
                      block_range: tuple[int, int] | None = None,
                      out_dim: int | None = None) -> torch.Tensor:
        """Serve-path forward (..., N) → (..., M) through the assembled
        P×Q grid.  Costs B·n_rows PTC calls (metered as ``serve``)."""

    @abc.abstractmethod
    def readback_bases(self, cols=None, *,
                       block_range: tuple[int, int] | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """Reciprocal-probe readout of the realized bases (U, V*), each
        (B, k, k), or only the columns ``cols``.  Costs 2·B·k PTC calls
        (2·B·len(cols) for a partial one)."""

    # -- in-situ jobs (run on the device's local controller; metered) --------

    @abc.abstractmethod
    def zo_refine(self, w_blocks: torch.Tensor, gen: torch.Generator | None,
                  cfg, method: str = "zcd", *,
                  block_range: tuple[int, int] | None = None,
                  draws: torch.Tensor | None = None) -> ZORefineResult:
        """Hardware-restricted alternate ZCD on the commanded phases against
        per-block targets, warm-started from the written state.  Writes
        the result and returns it.  Costs steps·2·B·k PTC calls."""

    @abc.abstractmethod
    def run_ic(self, gen: torch.Generator | None, sigs: torch.Tensor, cfg,
               *, restarts: int = 4, method: str = "zcd",
               draws: torch.Tensor | None = None) -> ICJobResult:
        """Identity Calibration: ZO search on the multi-Σ_cal intensity
        surrogate (Eq. 2) with probe attenuator schedule ``sigs``."""

    # -- time ----------------------------------------------------------------

    @abc.abstractmethod
    def advance(self, dt: float = 1.0) -> None:
        """Let ``dt`` ticks of (virtual) time pass."""

    # -- accounting ----------------------------------------------------------

    @property
    @abc.abstractmethod
    def stats(self) -> DriverStats:
        """Cumulative PTC-call meter."""

    @abc.abstractmethod
    def charge(self, category: str, calls: float) -> None:
        """Meter probes consumed by controller-side estimators."""

    def reset_stats(self) -> None:
        s = self.stats
        s.serve = s.probe = s.readback = s.search = 0.0

    # -- batched op lists ----------------------------------------------------

    def run_batch(self, ops: "list[tuple[str, dict]]") -> list:
        """Execute an ordered op list of :data:`BATCHABLE_OPS`; returns the
        per-op results (``"stats"`` yields a snapshot of the meter)."""
        validate_batch_ops(ops)
        out = []
        for name, kw in ops:
            if name == "stats":
                s = self.stats
                out.append(DriverStats(serve=s.serve, probe=s.probe,
                                       readback=s.readback, search=s.search))
            else:
                out.append(getattr(self, name)(**kw))
        return out

    def run_batch_async(self, ops: "list[tuple[str, dict]]"):
        """Issue an op list for asynchronous collection; ``result()`` is
        exactly what :meth:`run_batch` returns for the same list.  This
        default runs it at once and returns a :class:`CompletedBatch`."""
        return CompletedBatch(self.run_batch(ops))

    def flush(self) -> None:
        """Force client-side pipelined writes onto the device (no-op for
        in-process drivers, which apply writes eagerly)."""

    # -- lifecycle / escape hatch --------------------------------------------

    def close(self) -> None:
        """Release transport resources (no-op for in-process drivers)."""

    def unsafe_twin(self):
        """Escape hatch to the digital twin's internals (exact distances,
        the drifted realization); tests, benchmarks and the fleet's
        diagnostics only.  Raises :class:`TwinUnavailable` on a device that
        is not an inspectable twin."""
        raise TwinUnavailable(
            f"{type(self).__name__} is not backed by an inspectable twin")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
