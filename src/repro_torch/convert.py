"""Carry state from the reference package into the port's tensors.

The reference's objects arrive as anything ``numpy.asarray`` reads (JAX
arrays included) inside NamedTuples or dataclasses; this module maps them
field by field onto the port's types without importing either JAX or the
reference.  The parity tests use it to give both packages one device
realization, one set of weights and one commanded state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.noise import NoiseModel, PhaseNoise
from .core.ptc import PTCParams
from .core.subspace import SubspaceMasks
from .hw.device import DeviceRealization  # repro: noqa[RPL101]
from .optim.zo import ZOConfig

__all__ = ["tensor", "named_tuple", "phase_noise", "device_realization",
           "ptc_params", "weights", "commanded_state", "noise_model",
           "zo_config", "param_tree", "subspace_masks", "lm_params"]


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
