"""`TwinDriver`: the in-process digital-twin implementation of the ABC.

Counterpart of ``repro/hw/twin.py``.  Probe and serve forwards always go
through the PTC kernel (:func:`repro_torch.kernels.ptc_block_matmul`) and
every realized unitary through the mesh kernel; the tensors' device
decides whether the kernels or their plain versions run.  The in-situ
jobs delegate to :mod:`repro_torch.hw.jobs`.

Drift entropy is device-owned: with ``drift=`` the driver holds its own
CPU generator (seeded by :func:`make_twin` from the caller's), so a fleet
trajectory follows from construction seeds alone, alike on the CPU and on
the card, and the control plane never supplies drift randomness.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import unitary as un
from ..core.noise import NoiseModel, PhaseNoise
from ..device import resolve_device
from ..kernels.ptc_block_matmul import ptc_block_matmul
from ..optim.zo import ZOConfig
from . import jobs
from .device import (DeviceRealization, sample_device,  # repro: noqa[RPL101]
                     realized_unitaries, realized_blocks,
                     true_mapping_distance)
from .drift import DriftConfig, DriftState, init_drift, advance, \
    bias_deviation  # repro: noqa[RPL103]
from .driver import (PhotonicDriver, DriverStats, ZORefineResult, ICJobResult,
                     probe_cost, readback_cost, resolve_block_range,
                     forward_coalesce_key, coalesce_spans,
                     validate_batch_ops)

__all__ = ["TwinDriver", "TwinHandle", "make_twin"]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _map_dev(dev: DeviceRealization, fn) -> DeviceRealization:  # repro: noqa[RPL103]
    """``fn`` applied to every tensor of a realization."""
    return DeviceRealization(  # repro: noqa[RPL103]
        *(PhaseNoise(*map(fn, n)) for n in (dev.noise_u, dev.noise_v)),
        fn(dev.d_u), fn(dev.d_v))


class TwinHandle:
    """Quarantined readouts of a twin's internals (tests, benchmarks and
    the fleet's diagnostics only), obtained through ``driver.unsafe_twin()``."""

    def __init__(self, driver: "TwinDriver"):
        self._d = driver

    @property
    def dev(self) -> DeviceRealization:  # repro: noqa[RPL103]
        """The current (drifted) device realization."""
        return self._d._state.dev

    @property
    def anchor(self) -> DeviceRealization:  # repro: noqa[RPL103]
        """The manufacturing realization the OU drift reverts to."""
        return self._d._state.anchor

    @property
    def drift_state(self) -> DriftState:  # repro: noqa[RPL103]
        return self._d._state

    def realized_unitaries(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Free full readout of the realized bases (no PTC charge)."""
        d = self._d
        return d._realized(d._phi, d._state.dev)

    def realized_blocks(self) -> torch.Tensor:
        d = self._d
        return realized_blocks(d._spec, d._phi, d._sigma, d._state.dev,  # repro: noqa[RPL103]
                               d._model)

    def true_mapping_distance(self, w_blocks,
                              block_range: tuple[int, int] | None = None
                              ) -> float:
        """Exact aggregate mapping distance (full-readout ground truth),
        scoped to ``block_range`` (``w_blocks`` then carries the range's
        blocks)."""
        d = self._d
        _, _, phi, sigma, dev = d._slice(block_range)
        return float(true_mapping_distance(  # repro: noqa[RPL103]
            d._spec, phi, sigma, dev, d._model, _f32(w_blocks, d._device)))

    def bias_deviation(self) -> float:
        """RMS phase-bias deviation from the anchor (radians)."""
        return float(bias_deviation(self._d._state))  # repro: noqa[RPL103]


class TwinDriver(PhotonicDriver):
    """In-process digital twin behind the control-plane ABC."""

    def __init__(self, dev: DeviceRealization, k: int, model: NoiseModel,  # repro: noqa[RPL103]
                 kind: str = "clements", m: int | None = None,
                 n: int | None = None, device=None,
                 drift: DriftConfig | None = None,
                 drift_gen: torch.Generator | None = None):
        self._device = resolve_device(device)
        self._spec = un.mesh_spec(k, kind)
        self._kind = kind
        self._model = model
        self._state = init_drift(_map_dev(  # repro: noqa[RPL103]
            dev, lambda a: _f32(a, self._device)))
        self._drift_cfg = drift
        self._drift_gen = (drift_gen if drift_gen is not None
                           else torch.Generator("cpu").manual_seed(0))
        b = int(self._dev.d_u.shape[0])
        t = self._spec.n_rot
        self._b = b
        self._phi = torch.zeros((b, 2 * t), dtype=torch.float32,
                                device=self._device)
        self._sigma = torch.ones((b, k), dtype=torch.float32,
                                 device=self._device)
        # default layer geometry: a 1×B grid (calibration-style chips)
        self._m = int(m) if m is not None else k
        self._n = int(n) if n is not None else k * b
        self._stats = DriverStats()

    @property
    def _dev(self) -> DeviceRealization:  # repro: noqa[RPL103]
        """The current (drifted) realization."""
        return self._state.dev

    def _slice(self, block_range):
        """(start, stop, phi, sigma, dev) scoped to ``block_range``."""
        start, stop = resolve_block_range(self._b, block_range)
        if (start, stop) == (0, self._b):
            return start, stop, self._phi, self._sigma, self._dev
        return start, stop, self._phi[start:stop], \
            self._sigma[start:stop], \
            _map_dev(self._dev, lambda a: a[start:stop])

    def _realized(self, phi, dev):
        t = self._spec.n_rot
        return realized_unitaries(self._spec, phi[:, :t], phi[:, t:], dev,  # repro: noqa[RPL103]
                                  self._model)

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

    # -- commanded state -----------------------------------------------------

    def write_phases(self, phi_u, phi_v, *, block_range=None) -> None:
        t = self._spec.n_rot
        start, stop = resolve_block_range(self._b, block_range)
        nb = stop - start
        phi = torch.cat([_f32(phi_u, self._device).reshape(nb, t),
                         _f32(phi_v, self._device).reshape(nb, t)], dim=-1)
        if nb == self._b:
            self._phi = phi
        else:
            self._phi = self._phi.clone()
            self._phi[start:stop] = phi

    def write_sigma(self, sigma, *, block_range=None) -> None:
        start, stop = resolve_block_range(self._b, block_range)
        sigma = _f32(sigma, self._device).reshape(stop - start, self.k)
        if stop - start == self._b:
            self._sigma = sigma.contiguous()
        else:
            self._sigma = self._sigma.clone()
            self._sigma[start:stop] = sigma

    def write_signs(self, d_u, d_v, *, block_range=None) -> None:
        start, stop = resolve_block_range(self._b, block_range)
        nb = stop - start
        d_u = _f32(d_u, self._device).reshape(nb, self.k)
        d_v = _f32(d_v, self._device).reshape(nb, self.k)
        if nb != self._b:
            full_u, full_v = self._dev.d_u.clone(), self._dev.d_v.clone()
            full_u[start:stop], full_v[start:stop] = d_u, d_v
            d_u, d_v = full_u, full_v
        # signs are topological: they configure both the live device and
        # the drift anchor (OU never walks them)
        d_u, d_v = d_u.contiguous(), d_v.contiguous()
        self._state = DriftState(  # repro: noqa[RPL103]
            anchor=self._state.anchor._replace(d_u=d_u, d_v=d_v),
            dev=self._state.dev._replace(d_u=d_u, d_v=d_v),
            t=self._state.t)

    def read_phases(self) -> tuple[torch.Tensor, torch.Tensor]:
        t = self._spec.n_rot
        return self._phi[:, :t], self._phi[:, t:]

    def read_sigma(self) -> torch.Tensor:
        return self._sigma

    # -- probes --------------------------------------------------------------

    def forward(self, x, category: str = "probe", *,
                block_range=None) -> torch.Tensor:
        x = _f32(x, self._device).contiguous()
        start, stop, phi, sigma, dev = self._slice(block_range)
        u, v = self._realized(phi, dev)
        # per-block probe = the PTC kernel on a (B, 1) block grid
        y = ptc_block_matmul(x, u[:, None], sigma[:, None].contiguous(),
                             v[:, None])                  # (n, B·k)
        self._stats.charge(category, probe_cost(stop - start, x.shape[0]))
        return y.reshape(x.shape[0], stop - start, self.k).transpose(0, 1)

    def forward_many(self, xs, category: str = "probe", *,
                     block_range=None) -> list:
        """Coalesced probe sweep: N same-shape :meth:`forward` ops, the
        realized bases built once for all of them.  Each op's PTC launch is
        the one :meth:`forward` makes for it (same shape, so the same
        route and summation order), so every result equals a separate
        :meth:`forward` bit for bit; each op is charged on its own."""
        return list(self.forward_many_stacked(xs, category,
                                              block_range=block_range))

    def forward_many_stacked(self, xs, category: str = "probe", *,
                             block_range=None) -> torch.Tensor:
        """:meth:`forward_many` as one stacked ``(N, B, n, k)`` tensor;
        ``xs`` is a sequence of same-shape ``(n, k)`` inputs or the
        stacked ``(N, n, k)`` tensor or host array (a server's decoded
        span: moved to the device in one copy, not one a probe)."""
        if isinstance(xs, np.ndarray):
            xs = _f32(xs, self._device)
        xs = [_f32(x, self._device).contiguous() for x in xs]
        start, stop, phi, sigma, dev = self._slice(block_range)
        u, v = self._realized(phi, dev)
        u, v, sigma = u[:, None], v[:, None], sigma[:, None].contiguous()
        ys = []
        for x in xs:
            y = ptc_block_matmul(x, u, sigma, v)         # (n, B·k)
            ys.append(y.reshape(x.shape[0], stop - start,
                                self.k).transpose(0, 1))
            self._stats.charge(category, probe_cost(stop - start,
                                                    x.shape[0]))
        return torch.stack(ys)

    def run_batch(self, ops):
        """Sequential dispatch, with consecutive same-shape ``forward`` ops
        coalesced through :meth:`forward_many` (the merge rule is
        ``driver.coalesce_spans``); results and meter charges equal plain
        sequential execution bit for bit."""
        validate_batch_ops(ops)
        keys = [forward_coalesce_key(kw) if name == "forward" else None
                for name, kw in ops]
        out = []
        for i, j in coalesce_spans(keys):
            if j - i > 1:
                kw = ops[i][1]
                out.extend(self.forward_many(
                    [op_kw.get("x") for _, op_kw in ops[i:j]],
                    category=kw.get("category", "probe"),
                    block_range=kw.get("block_range")))
            else:
                out.extend(super().run_batch([ops[i]]))
        return out

    def forward_layer(self, x, *, block_range=None,
                      out_dim: int | None = None) -> torch.Tensor:
        x = _f32(x, self._device)
        start, stop, phi, sigma, dev = self._slice(block_range)
        k = self.k
        m_out = int(out_dim) if out_dim is not None else self._m
        b = stop - start
        p = -(-m_out // k)
        q = b // p
        u, v = self._realized(phi, dev)
        xf = x.reshape(-1, x.shape[-1])
        if xf.shape[-1] != q * k:
            xf = F.pad(xf, (0, q * k - xf.shape[-1]))
        y = ptc_block_matmul(xf.contiguous(), u.reshape(p, q, k, k),
                             sigma.reshape(p, q, k).contiguous(),
                             v.reshape(p, q, k, k))      # (T, p·k)
        n_cols = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        self._stats.charge("serve", probe_cost(b, n_cols))
        return y[:, :m_out].reshape(x.shape[:-1] + (m_out,))

    def readback_bases(self, cols=None, *,
                       block_range=None) -> tuple[torch.Tensor, torch.Tensor]:
        start, stop, phi, _, dev = self._slice(block_range)
        u, v = self._realized(phi, dev)
        if cols is not None:
            idx = torch.as_tensor(cols, dtype=torch.long, device=self._device)
            u, v = u[..., :, idx], v[..., :, idx]
            self._stats.charge("readback",
                               readback_cost(stop - start, int(idx.shape[0])))
        else:
            self._stats.charge("readback", readback_cost(stop - start, self.k))
        return u, v

    # -- in-situ jobs --------------------------------------------------------

    def _foreign(self, gen, draws) -> bool:
        """A generator on another device than the twin's: the job then runs
        on the draws it would make (:func:`jobs.job_draws`), so a CPU
        generator drives a twin on the card with the bits it gives on the
        CPU."""
        return draws is None and gen is not None and \
            gen.device.type != self._device.type

    def zo_refine(self, w_blocks, gen, cfg: ZOConfig, method: str = "zcd", *,
                  block_range=None, draws=None) -> ZORefineResult:
        start, stop, phi, sigma, dev = self._slice(block_range)
        if self._foreign(gen, draws):
            draws, gen = jobs.job_draws(gen, method, stop - start, cfg.steps,
                                        self._spec.n_rot), None
        res = jobs.phase_refine(self._spec, self._model, dev, phi, sigma,
                                _f32(w_blocks, self._device), gen, cfg,
                                method, draws)
        if stop - start == self._b:
            self._phi = res.x
        else:
            self._phi = self._phi.clone()
            self._phi[start:stop] = res.x
        # each ZCD step issues ≤2 transfer-matrix evaluations of k columns
        self._stats.charge("search",
                           float(cfg.steps * 2 * (stop - start) * self.k))
        return ZORefineResult(phi=res.x, loss=res.f, history=res.history,
                              steps=int(cfg.steps))

    def run_ic(self, gen, sigs, cfg: ZOConfig, *, restarts: int = 4,
               method: str = "zcd", draws=None) -> ICJobResult:
        sigs = _f32(sigs, self._device)
        if self._foreign(gen, draws):
            draws, gen = jobs.job_draws(gen, method, self._b, cfg.steps,
                                        self._spec.n_rot, restarts), None
        phi, loss, history = jobs.ic_search(
            self._spec, self._model, self._dev, gen, cfg, sigs, method,
            restarts, draws)
        self._phi = phi
        u, v = self._realized(phi, self._dev)
        # one surrogate measurement = k unit-vector probes per Σ_cal
        # setting; ZCD spends ≤2 measurements per step
        self._stats.charge("search", float(
            restarts * cfg.steps * 2 * sigs.shape[0] * self.k * self._b))
        self._stats.charge("readback", readback_cost(self._b, self.k))
        return ICJobResult(phi=phi, u=u, v=v, loss=loss, history=history)

    # -- time ----------------------------------------------------------------

    def advance(self, dt: float = 1.0) -> None:
        """One OU step of the drift chain (time passes without effect when
        the twin was built without ``drift=``)."""
        if self._drift_cfg is None:
            return
        self._state = advance(self._state, dt, self._drift_gen,  # repro: noqa[RPL103]
                              self._drift_cfg)

    # -- accounting / escape hatch -------------------------------------------

    @property
    def stats(self) -> DriverStats:
        return self._stats

    def charge(self, category: str, calls: float) -> None:
        self._stats.charge(category, calls)

    def unsafe_twin(self) -> TwinHandle:  # repro: noqa[RPL103]
        return TwinHandle(self)  # repro: noqa[RPL103]


def make_twin(gen: torch.Generator | None, n_blocks: int, k: int,
              model: NoiseModel, kind: str = "clements", *,
              m: int | None = None, n: int | None = None,
              drift: DriftConfig | None = None,
              dev: DeviceRealization | None = None,  # repro: noqa[RPL103]
              device=None) -> TwinDriver:
    """Sample a fresh device from ``gen`` on the generator's device (or
    wrap ``dev``, e.g. one carried across from the reference with
    :mod:`repro_torch.convert`) behind a TwinDriver on ``device`` (``cuda``
    by default).  With ``drift=`` the twin's drift chain is a CPU
    generator seeded by one draw from ``gen`` after the device's (seed 0
    when ``gen`` is None), so one seed pins the whole chip trajectory."""
    device = resolve_device(device)
    if dev is None:
        if gen is None:
            raise ValueError("make_twin: pass gen= to sample a device, "
                             "or dev=")
        dev = sample_device(gen, (n_blocks,), k, model, kind)  # repro: noqa[RPL103]
    drift_gen = None
    if drift is not None and gen is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device))
        drift_gen = torch.Generator("cpu").manual_seed(seed)
    return TwinDriver(dev, k, model, kind, m=m, n=n, device=device,
                      drift=drift, drift_gen=drift_gen)
