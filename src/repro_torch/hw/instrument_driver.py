"""`ReferenceInstrumentDriver`: the ABC minus ``unsafe_twin()``.

Counterpart of ``repro/hw/instrument_driver.py``.  A driver skeleton that
implements every :class:`~repro_torch.hw.driver.PhotonicDriver` contract a
controller can own (geometry, the commanded-state mirror, tenant
``block_range`` validation, the Appendix-G PTC meter with the twin's
charges, batching, the clock) and delegates the operations that touch
light to abstract ``_hw_*`` hooks.  An instrument integrator fills in the
hooks against their lab I/O (DAC writes, detector reads, the device's
local ZO controller), and everything above the ABC (calibration, mapping,
monitoring, recalibration, fleet serving, the wire server) runs against
real hardware unchanged.

It does not provide ``unsafe_twin()``: real hardware has no inspectable
internals, so the inherited hatch raises
:class:`~repro_torch.hw.driver.TwinUnavailable`.  ``read_phases`` /
``read_sigma`` answer from the mirror of what was commanded, as the ABC
specifies.

Hook contract (scoped arrays carry ``stop - start`` blocks first; inputs
are float32 tensors on the driver's ``device``):

===========================  ============================================
``_hw_apply_phases``         commit scoped (B, T) + (B, T) phase banks
``_hw_apply_sigma``          commit scoped (B, k) attenuators
``_hw_apply_signs``          commit scoped (B, k) + (B, k) sign banks
``_hw_forward``              probe columns (n, k) → (B, n, k)
``_hw_forward_layer``        serve rows (rows, n_in) → (rows, out_dim)
``_hw_readback``             reciprocal readout → (U, V*) columns
``_hw_zo_refine``            device-local ZO job → (phi, loss, history)
``_hw_run_ic``               device-local IC job → (phi, u, v, loss,
                             history)
===========================  ============================================

The jobs' hooks receive the search's per-step draws: a caller's generator
is turned into the draws the twin's job would make from it
(:func:`~repro_torch.hw.jobs.job_draws`).
"""

from __future__ import annotations

import abc

import torch

from ..core import unitary as un
from ..device import resolve_device
from .driver import (PhotonicDriver, DriverStats, ZORefineResult, ICJobResult,
                     probe_cost, readback_cost, resolve_block_range)
from .jobs import job_draws

__all__ = ["ReferenceInstrumentDriver"]


class ReferenceInstrumentDriver(PhotonicDriver):
    """Control-plane bookkeeping for a real photonic instrument: concrete
    in everything the observability model lets a controller own, abstract
    in the operations that need a physical chip."""

    def __init__(self, n_blocks: int, k: int, kind: str = "clements", *,
                 m: int | None = None, n: int | None = None, device=None):
        self._spec = un.mesh_spec(k, kind)
        self._kind = kind
        self._b = int(n_blocks)
        self._device = resolve_device(device)
        # controller-side mirror of the commanded state (the free reads)
        t = self._spec.n_rot
        f32 = dict(dtype=torch.float32, device=self._device)
        self._phi = torch.zeros((self._b, 2 * t), **f32)
        self._sigma = torch.ones((self._b, k), **f32)
        self._d_u = torch.ones((self._b, k), **f32)
        self._d_v = torch.ones((self._b, k), **f32)
        # default layer geometry: a 1×B grid, as make_twin's
        self._m = int(m) if m is not None else k
        self._n = int(n) if n is not None else k * self._b
        self._stats = DriverStats()
        self._clock = 0.0

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self._device)

    # -- physical I/O hooks (the integrator's surface) -----------------------

    @abc.abstractmethod
    def _hw_apply_phases(self, phi_u: torch.Tensor, phi_v: torch.Tensor,
                         start: int, stop: int) -> None:
        """Drive the phase shifters of blocks [start, stop)."""

    @abc.abstractmethod
    def _hw_apply_sigma(self, sigma: torch.Tensor,
                        start: int, stop: int) -> None:
        """Drive the Σ attenuators of blocks [start, stop)."""

    @abc.abstractmethod
    def _hw_apply_signs(self, d_u: torch.Tensor, d_v: torch.Tensor,
                        start: int, stop: int) -> None:
        """Configure the ±1 crossings of blocks [start, stop)."""

    @abc.abstractmethod
    def _hw_forward(self, x: torch.Tensor, start: int,
                    stop: int) -> torch.Tensor:
        """Stream probe columns ``x`` (n, k) through blocks [start, stop);
        the detector readout, (stop - start, n, k)."""

    @abc.abstractmethod
    def _hw_forward_layer(self, x: torch.Tensor, start: int, stop: int,
                          out_dim: int) -> torch.Tensor:
        """Serve-path forward through the assembled sub-grid of blocks
        [start, stop): (rows, n_in) → (rows, out_dim)."""

    @abc.abstractmethod
    def _hw_readback(self, cols: list, start: int, stop: int):
        """Reciprocal-probe basis readout of blocks [start, stop): ``(U,
        V*)`` columns, each (stop - start, k, len(cols))."""

    @abc.abstractmethod
    def _hw_zo_refine(self, w_blocks: torch.Tensor, draws: torch.Tensor,
                      cfg, method: str, start: int, stop: int):
        """Device-local hardware-restricted ZO against per-block targets on
        the per-step ``draws``; returns ``(phi, loss, history)``, phi
        (stop - start, 2T).  The skeleton mirrors phi and meters the
        search."""

    @abc.abstractmethod
    def _hw_run_ic(self, draws: torch.Tensor, sigs: torch.Tensor, cfg,
                   restarts: int, method: str):
        """Device-local Identity Calibration on the per-restart ``draws``;
        returns ``(phi, u, v, loss, history)``.  The skeleton mirrors phi
        and meters the search and the readback."""

    # -- geometry ------------------------------------------------------------

    @property
    def k(self) -> int:
        return self._spec.k

    @property
    def kind(self) -> str:
        return self._kind

    @property
    def n_blocks(self) -> int:
        return self._b

    @property
    def layer_shape(self) -> tuple[int, int]:
        return self._m, self._n

    @property
    def device(self) -> torch.device:
        return self._device

    # -- commanded state (mirror + commit) -----------------------------------

    def write_phases(self, phi_u, phi_v, *, block_range=None) -> None:
        t = self._spec.n_rot
        start, stop = resolve_block_range(self._b, block_range)
        nb = stop - start
        phi_u = self._f32(phi_u).reshape(nb, t)
        phi_v = self._f32(phi_v).reshape(nb, t)
        self._phi[start:stop, :t] = phi_u
        self._phi[start:stop, t:] = phi_v
        self._hw_apply_phases(phi_u, phi_v, start, stop)

    def write_sigma(self, sigma, *, block_range=None) -> None:
        start, stop = resolve_block_range(self._b, block_range)
        sigma = self._f32(sigma).reshape(stop - start, self.k)
        self._sigma[start:stop] = sigma
        self._hw_apply_sigma(sigma, start, stop)

    def write_signs(self, d_u, d_v, *, block_range=None) -> None:
        start, stop = resolve_block_range(self._b, block_range)
        nb = stop - start
        d_u = self._f32(d_u).reshape(nb, self.k)
        d_v = self._f32(d_v).reshape(nb, self.k)
        self._d_u[start:stop] = d_u
        self._d_v[start:stop] = d_v
        self._hw_apply_signs(d_u, d_v, start, stop)

    def read_phases(self):
        t = self._spec.n_rot
        return self._phi[:, :t].clone(), self._phi[:, t:].clone()

    def read_sigma(self):
        return self._sigma.clone()

    # -- probes (metered as the twin meters them) ----------------------------

    def forward(self, x, category: str = "probe", *, block_range=None):
        x = self._f32(x)
        start, stop = resolve_block_range(self._b, block_range)
        y = self._hw_forward(x, start, stop)
        self._stats.charge(category, probe_cost(stop - start, x.shape[0]))
        return y

    def forward_layer(self, x, *, block_range=None,
                      out_dim: int | None = None):
        x = self._f32(x)
        start, stop = resolve_block_range(self._b, block_range)
        if out_dim is None:
            out_dim = self._m if (start, stop) == (0, self._b) else \
                (stop - start) * self.k
        lead, n_in = x.shape[:-1], x.shape[-1]
        rows = x.reshape(-1, n_in)
        y = self._hw_forward_layer(rows, start, stop, int(out_dim))
        self._stats.charge("serve", probe_cost(stop - start, rows.shape[0]))
        return y.reshape(*lead, int(out_dim))

    def readback_bases(self, cols=None, *, block_range=None):
        start, stop = resolve_block_range(self._b, block_range)
        if cols is not None:
            idx = [int(c) for c in torch.as_tensor(cols).reshape(-1)]
        else:
            idx = list(range(self.k))
        u, v = self._hw_readback(idx, start, stop)
        self._stats.charge("readback", readback_cost(stop - start, len(idx)))
        return u, v

    # -- in-situ jobs --------------------------------------------------------

    def _draws(self, gen, draws, method, b, steps, restarts=None):
        if draws is not None:
            return torch.as_tensor(draws)
        if gen is None:
            raise ValueError("pass exactly one of gen= or draws=")
        return job_draws(gen, method, b, steps, self._spec.n_rot, restarts)

    def zo_refine(self, w_blocks, gen, cfg, method: str = "zcd", *,
                  block_range=None, draws=None) -> ZORefineResult:
        start, stop = resolve_block_range(self._b, block_range)
        draws = self._draws(gen, draws, method, stop - start, cfg.steps)
        phi, loss, history = self._hw_zo_refine(
            self._f32(w_blocks), draws, cfg, method, start, stop)
        self._phi[start:stop] = self._f32(phi)
        # each ZCD step issues ≤2 transfer-matrix evaluations of k
        # columns: the twin's charge
        self._stats.charge("search",
                           float(cfg.steps * 2 * (stop - start) * self.k))
        return ZORefineResult(phi=phi, loss=loss, history=history,
                              steps=int(cfg.steps))

    def run_ic(self, gen, sigs, cfg, *, restarts: int = 4,
               method: str = "zcd", draws=None) -> ICJobResult:
        sigs = self._f32(sigs)
        draws = self._draws(gen, draws, method, self._b, cfg.steps,
                            int(restarts))
        phi, u, v, loss, history = self._hw_run_ic(
            draws, sigs, cfg, int(restarts), method)
        self._phi[:] = self._f32(phi)
        # one surrogate measurement = k unit-vector probes per Σ_cal
        # setting; ZCD spends ≤2 measurements a step: the twin's charges
        self._stats.charge("search", float(
            restarts * cfg.steps * 2 * sigs.shape[0] * self.k * self._b))
        self._stats.charge("readback", readback_cost(self._b, self.k))
        return ICJobResult(phi=phi, u=u, v=v, loss=loss, history=history)

    # -- time / accounting ---------------------------------------------------

    def advance(self, dt: float = 1.0) -> None:
        # real hardware drifts on its own; the controller keeps only the
        # virtual clock other bookkeeping (the recal cadence) is phrased in
        self._clock += float(dt)

    @property
    def clock(self) -> float:
        """Virtual time elapsed through :meth:`advance`."""
        return self._clock

    @property
    def stats(self) -> DriverStats:
        return self._stats

    def charge(self, category: str, calls: float) -> None:
        self._stats.charge(category, calls)

    # unsafe_twin() is not implemented: the inherited hatch raises
    # TwinUnavailable, as real hardware has no inspectable twin
