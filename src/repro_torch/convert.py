"""Carry state from the reference package into the port's tensors.

The reference's objects arrive as anything ``numpy.asarray`` reads (JAX
arrays included) inside NamedTuples or dataclasses; this module maps them
field by field onto the port's types without importing either JAX or the
reference.  The parity tests use it to give both packages one device
realization, one set of weights and one commanded state, one fleet
(:func:`fleet`: each chip's drift state, commanded state, meter, tenants
and counters), and one hardware-in-the-loop deployment (:func:`hw_plane`:
a reference ``HwServePlane``'s layers and deployed fleet behind a port
plane).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.noise import NoiseModel, PhaseNoise
from .core.ptc import PTCParams
from .core.subspace import SubspaceMasks
from .hw import DriftConfig, DriftState, make_twin
from .hw.device import DeviceRealization  # repro: noqa[RPL101]
from .optim.zo import ZOConfig
from .runtime.fleet import Chip, RuntimeConfig, Tenant
from .runtime.monitor import HealthState, MonitorConfig
from .runtime.recalibrate import RecalConfig

__all__ = ["tensor", "named_tuple", "phase_noise", "device_realization",
           "ptc_params", "weights", "commanded_state", "noise_model",
           "zo_config", "param_tree", "subspace_masks", "lm_params",
           "drift_config", "drift_state", "monitor_config", "recal_config",
           "runtime_config", "fleet", "ptc_layers", "hw_plane"]


def tensor(a, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """One array (numpy, JAX or a nested list) as a tensor on ``device``
    (copied, so the result never aliases a read-only buffer)."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def named_tuple(obj, cls, device="cpu"):
    """``cls`` built from ``obj``'s same-named fields, each as a tensor;
    the fields listed in ``_NESTED`` map onto the port's NamedTuple type
    there, recursively."""
    fields = {}
    for name in cls._fields:
        val = getattr(obj, name)
        sub = _NESTED.get((cls, name))
        fields[name] = named_tuple(val, sub, device) if sub is not None \
            else tensor(val, device)
    return cls(**fields)


_NESTED = {(DeviceRealization, "noise_u"): PhaseNoise,  # repro: noqa[RPL103]
           (DeviceRealization, "noise_v"): PhaseNoise}  # repro: noqa[RPL103]


def phase_noise(obj, device="cpu") -> PhaseNoise:
    return named_tuple(obj, PhaseNoise, device)


def device_realization(obj, device="cpu") -> DeviceRealization:  # repro: noqa[RPL103]
    return named_tuple(obj, DeviceRealization, device)  # repro: noqa[RPL103]


def ptc_params(obj, device="cpu") -> PTCParams:
    return named_tuple(obj, PTCParams, device)


def weights(ws, device="cpu") -> list[torch.Tensor]:
    """A list of dense weight matrices."""
    return [tensor(w, device) for w in ws]


def commanded_state(driver, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A driver's commanded ``(phi, sigma)``: phases as ``[Φ^U | Φ^V]``
    (B, 2T) and attenuators (B, k), read through its public surface."""
    phi_u, phi_v = driver.read_phases()
    phi = torch.cat([tensor(phi_u, device), tensor(phi_v, device)], dim=-1)
    return phi, tensor(driver.read_sigma(), device)


def noise_model(obj) -> NoiseModel:
    """A frozen noise-model dataclass, field by field."""
    return NoiseModel(**{f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(NoiseModel)})


def zo_config(obj) -> ZOConfig:
    """A ZO budget NamedTuple, field by field."""
    return ZOConfig(**{f: getattr(obj, f) for f in ZOConfig._fields})


def param_tree(tree, device="cpu") -> dict:
    """A nested dict of arrays (a model's parameters, e.g. the reference's
    ``init_cnn`` output with leaves ``u``, ``s``, ``v``, ``b``) as the same
    nesting of fp32 tensors."""
    return {name: param_tree(leaf, device) if isinstance(leaf, dict)
            else tensor(leaf, device) for name, leaf in tree.items()}


def subspace_masks(obj, device="cpu") -> SubspaceMasks | None:
    """A step's ``(feedback, column)`` masks; ``None`` stays ``None``."""
    if obj is None:
        return None
    return SubspaceMasks(*(None if m is None else tensor(m, device)
                           for m in (obj.feedback, obj.column)))


def lm_params(tree, device="cpu") -> dict:
    """A reference LM parameter tree (``repro.models.lm.init_model``: nested
    dicts, per-position leaves stacked on the period axis) as the same
    nesting of tensors, each leaf in its own dtype.

    A bf16 leaf arrives from ``numpy.asarray`` as ``ml_dtypes.bfloat16``,
    which torch cannot read: it goes through float32 (exact: every bf16
    value is a float32 value) and back to bf16."""
    if isinstance(tree, dict):
        return {name: lm_params(leaf, device) for name, leaf in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.as_tensor(np.array(a), device=device)


def _fields(obj, cls) -> dict:
    return {f: getattr(obj, f) for f in cls._fields}


def drift_config(obj) -> DriftConfig:
    """An OU drift configuration, field by field."""
    return DriftConfig(**_fields(obj, DriftConfig))


def drift_state(obj, device="cpu") -> DriftState:  # repro: noqa[RPL103]
    """A drifted realization with its anchor and clock."""
    return DriftState(anchor=device_realization(obj.anchor, device),  # repro: noqa[RPL103]
                      dev=device_realization(obj.dev, device),
                      t=float(np.asarray(obj.t)))


def monitor_config(obj) -> MonitorConfig:
    return MonitorConfig(**_fields(obj, MonitorConfig))


def recal_config(obj) -> RecalConfig:
    return RecalConfig(**_fields(obj, RecalConfig))


def runtime_config(obj) -> RuntimeConfig:
    """A fleet's policy, its noise, drift, monitor and recal configs
    inside; an autopilot config is carried field by field."""
    auto = obj.autopilot
    if auto is not None:
        from .runtime.autopilot import AutopilotConfig
        auto = AutopilotConfig(**{f.name: getattr(auto, f.name)
                                  for f in dataclasses.fields(
                                      AutopilotConfig)})
    kw = {f.name: getattr(obj, f.name)
          for f in dataclasses.fields(RuntimeConfig)}
    kw.update(noise=noise_model(obj.noise), drift=drift_config(obj.drift),
              monitor=monitor_config(obj.monitor),
              recal=recal_config(obj.recal), autopilot=auto)
    return RuntimeConfig(**kw)


def fleet(chips, cfg: RuntimeConfig, *, drift: DriftConfig | None = None,
          device="cpu") -> list[Chip]:
    """The reference fleet's chips as port chips on ``device``.

    Each chip's twin gets the reference twin's drift state (anchor, drifted
    realization, clock; read through its ``unsafe_twin()``), its commanded
    phases and Σ, and its PTC meter; ``drift`` is the new twins' own OU
    walk (None: time passes without effect, for a caller that carries the
    drifted realization across itself).  Tenants keep their layout,
    targets, health and counters; chips their status and counters."""
    out = []
    for c in chips:
        ref = c.driver
        state = drift_state(ref.unsafe_twin().drift_state, device)  # repro: noqa[RPL102]
        m, n = ref.layer_shape
        drv = make_twin(None, ref.n_blocks, ref.k, cfg.noise, ref.kind,
                        m=m, n=n, drift=drift, dev=state.dev, device=device)
        drv._state = state      # the anchor and clock too, not only dev
        phi_u, phi_v = ref.read_phases()
        drv.write_phases(tensor(phi_u, device), tensor(phi_v, device))
        drv.write_sigma(tensor(ref.read_sigma(), device))
        for cat, calls in ref.stats.as_dict().items():
            if cat != "total":
                setattr(drv.stats, cat, float(calls))
        tenants = [Tenant(
            tenant_id=t.tenant_id, m=t.m, n=t.n,
            block_range=tuple(int(i) for i in t.block_range),
            w_blocks=tensor(t.w_blocks, device),
            health=HealthState(**dataclasses.asdict(t.health)),
            last_probe_tick=t.last_probe_tick, served=t.served,
            alarms=t.alarms, recals=t.recals, recal_calls=t.recal_calls)
            for t in c.tenants]
        out.append(Chip(
            chip_id=c.chip_id, driver=drv, tenants=tenants, status=c.status,
            recal_ticks_left=c.recal_ticks_left,
            recal_tenant=c.recal_tenant, recal_proactive=c.recal_proactive,
            offline_ticks_left=c.offline_ticks_left, served=c.served,
            alarms=c.alarms, recals=c.recals, recal_calls=c.recal_calls))
    return out


def ptc_layers(specs, device="cpu") -> list:
    """A reference plane's ``PTCLayerSpec`` list (name, geometry, group and
    the effective weight, fp32) as the port's."""
    from .runtime.hw_serve import PTCLayerSpec
    return [PTCLayerSpec(index=s.index, name=s.name, m=s.m, n=s.n,
                         w=tensor(s.w, device), group=s.group)
            for s in specs]


def hw_plane(plane, cfg: RuntimeConfig, *, mode: str | None = None,
             seed: int = 0, recal_enabled: bool = True,
             drift: DriftConfig | None = None, device="cpu"):
    """A port ``HwServePlane`` serving a reference plane's deployment: its
    layers and its router's chips as they stand (:func:`fleet`; carry them
    before the reference serves, which moves them).  ``mode`` defaults to
    the reference plane's; ``drift`` is the twins' own OU walk."""
    from .runtime.hw_serve import HwServePlane
    chips = fleet(plane.router.chips, cfg, drift=drift, device=device)
    return HwServePlane(None, ptc_layers(plane.layers, device), cfg,
                        len(chips), mode=mode or plane.mode, seed=seed,
                        recal_enabled=recal_enabled, chips=chips)
