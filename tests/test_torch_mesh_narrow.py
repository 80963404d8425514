"""The narrow ``mesh_apply`` kernel's compile-time rotation patterns and
its host table (``kernels/mesh_apply.py::narrow_plan``), on the CPU.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against its plain version at 1e-5); here:

* At each compiled width (4, 8, 9, 16, 32) and both kinds the pattern is
  the mesh's own application order (``mesh_spec(k, kind).pairs``, each
  rotation on adjacent wires), so the kernel needs no table there.
* For every k in 2..32 and both kinds, the plan's wire offset and slot
  table put every rotation of the k mesh, in its order, on the compiled
  pattern; an emulation of the kernel (its rows as kk wires, the pattern
  in order, rotations with slot -1 skipped) matches the plain version on
  the spec's layer tables (``layer_tables``, the layered order) to 1e-6,
  and the reference package's ``apply_mesh`` at a few k.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unitary as jun
from repro_torch.core.unitary import mesh_spec
from repro_torch.kernels.mesh_apply import layer_tables, narrow_plan
from repro_torch.kernels.ref import mesh_apply_ref

KINDS = ("clements", "reck")


@pytest.mark.parametrize("kk", [4, 8, 9, 16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_compiled_pattern_is_the_mesh_order(kk, kind):
    spec = mesh_spec(kk, kind)
    assert spec.pairs.shape == (spec.n_rot, 2)
    assert np.array_equal(spec.pairs[:, 1], spec.pairs[:, 0] + 1)
    plan = narrow_plan(kk, kind)
    assert (plan.kk, plan.off, plan.slot) == (kk, 0, None)


def _emulate(k, kind, ph, x, d):
    """The kernel's arithmetic for a (k, kind) mesh: the row on the
    compiled width's wires at the plan's offset, the pattern's rotations
    in order, each with its slot's (cos, sin)."""
    plan = narrow_plan(k, kind)
    upper = mesh_spec(plan.kk, kind).pairs[:, 0]
    slot = np.arange(len(upper)) if plan.slot is None else plan.slot
    v = torch.zeros(x.shape[:-1] + (plan.kk,))
    v[..., plan.off:plan.off + k] = x * d
    c, s = torch.cos(ph), torch.sin(ph)
    for a, t in zip(upper.tolist(), slot.tolist()):
        if t < 0:
            continue
        x0, x1 = v[..., a].clone(), v[..., a + 1].clone()
        v[..., a] = c[..., t] * x0 - s[..., t] * x1
        v[..., a + 1] = s[..., t] * x0 + c[..., t] * x1
    return v[..., plan.off:plan.off + k]


@pytest.mark.parametrize("k", range(2, 33))
@pytest.mark.parametrize("kind", KINDS)
def test_plan_runs_every_k_on_its_compiled_pattern(k, kind):
    spec = mesh_spec(k, kind)
    plan = narrow_plan(k, kind)
    assert plan.kk >= k and plan.kk in (4, 8, 9, 16, 32)
    assert 0 <= plan.off and plan.off + k <= plan.kk
    if plan.slot is not None:
        upper = mesh_spec(plan.kk, kind).pairs[:, 0]
        kept = plan.slot >= 0
        # every phase slot once, in order, on the k mesh's wires
        assert np.array_equal(plan.slot[kept], np.arange(spec.n_rot))
        assert np.array_equal(upper[kept] - plan.off, spec.pairs[:, 0])
    rng = np.random.default_rng(k * 2 + (kind == "reck"))
    ph = torch.from_numpy(rng.uniform(-np.pi, np.pi, (3, spec.n_rot))
                          .astype(np.float32))
    d = torch.from_numpy(np.where(rng.random((3, k)) < 0.5, -1.0, 1.0)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 5, k)).astype(np.float32))
    slot, partner, sign = layer_tables(k, kind, torch.device("cpu"))
    want = mesh_apply_ref(x, ph[:, None], slot, partner, sign, d[:, None])
    got = _emulate(k, kind, ph[:, None], x, d[:, None])
    assert float((got - want).abs().max()) < 1e-6


@pytest.mark.parametrize("k,kind", [(3, "reck"), (5, "clements"),
                                    (13, "reck"), (13, "clements"),
                                    (20, "reck")])
def test_plan_matches_reference_apply_mesh(k, kind):
    spec = jun.mesh_spec(k, kind)
    rng = np.random.default_rng(k)
    ph = rng.uniform(-np.pi, np.pi, spec.n_rot).astype(np.float32)
    d = np.where(rng.random(k) < 0.5, -1.0, 1.0).astype(np.float32)
    x = rng.standard_normal((7, k)).astype(np.float32)
    want = np.asarray(jun.apply_mesh(spec, jnp.asarray(ph), jnp.asarray(x),
                                     jnp.asarray(d)), np.float32)
    got = _emulate(k, kind, torch.from_numpy(ph), torch.from_numpy(x),
                   torch.from_numpy(d)).numpy()
    assert np.abs(got - want).max() < 1e-5


def test_plan_refuses_wide_and_degenerate_k():
    for k in (1, 33, 128):
        with pytest.raises(ValueError):
            narrow_plan(k, "reck")
    with pytest.raises(ValueError):
        narrow_plan(8, "butterfly")
