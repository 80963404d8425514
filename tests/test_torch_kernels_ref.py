"""Port parity: the kernels' plain versions against ``repro.kernels.ops``.

On a CPU tensor the port's wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` does.  Tolerances are the reference suite's:
1e-4 relative to the largest output for the fp32 PTC forward (sums taken
in another order), 6e-2 for bf16 (the Pallas kernel accumulates in bf16,
the port in fp32), 1e-5 absolute for the mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unitary as jun
from repro.kernels import ops
from repro_torch.core import unitary as tun
from repro_torch.kernels import (build, mesh_apply, mesh_apply_batched,
                                 ptc_block_matmul, ref)

PTC_SHAPES = [(8, 2, 3, 8), (64, 4, 4, 16), (32, 1, 1, 9), (16, 3, 2, 4),
              (128, 2, 2, 32),
              (37, 2, 2, 9)]      # ragged T: no row tile divides it


def _ptc_inputs(t, p, q, k):
    rng = np.random.default_rng(t * 100 + p * 10 + q)
    return (rng.standard_normal((t, q * k)), rng.standard_normal((p, q, k, k)),
            rng.standard_normal((p, q, k)), rng.standard_normal((p, q, k, k)))


@pytest.mark.parametrize("t,p,q,k", PTC_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ptc_block_matmul_plain_matches_reference(t, p, q, k, dtype):
    arrs = _ptc_inputs(t, p, q, k)
    yj = ops.ptc_block_matmul(*(jnp.asarray(a, dtype) for a in arrs))
    tdt = getattr(torch, dtype)
    before = dict(build.launch_counts)
    yt = ptc_block_matmul(*(torch.from_numpy(a.astype(np.float32)).to(tdt)
                            for a in arrs))
    assert yt.shape == (t, p * k) and yt.dtype == tdt
    assert build.launch_counts == before     # the plain path launches nothing
    yj = np.asarray(yj.astype(jnp.float32))
    err = np.abs(yt.float().numpy() - yj).max() / (np.abs(yj).max() + 1e-6)
    assert err < (1e-4 if dtype == "float32" else 6e-2), err


def test_ptc_block_matmul_ref_is_the_wrapper_on_cpu():
    arrs = [torch.from_numpy(a.astype(np.float32))
            for a in _ptc_inputs(16, 3, 2, 4)]
    assert torch.equal(ptc_block_matmul(*arrs), ref.ptc_block_matmul_ref(*arrs))


def test_ptc_block_matmul_rejects_bad_inputs():
    x, u, s, v = (torch.from_numpy(a.astype(np.float32))
                  for a in _ptc_inputs(8, 2, 3, 8))
    with pytest.raises(ValueError):
        ptc_block_matmul(x[:, :-1], u, s, v)
    with pytest.raises(TypeError):
        ptc_block_matmul(x.double(), u, s, v)
    with pytest.raises(ValueError):
        ptc_block_matmul(x.t().contiguous().t(), u, s, v)
    # neither CPU nor CUDA: no silent plain version
    with pytest.raises(ValueError):
        ptc_block_matmul(*(a.to("meta") for a in (x, u, s, v)))


@pytest.mark.parametrize("k", [2, 4, 8, 9, 13, 16])
@pytest.mark.parametrize("kind", ["clements", "reck"])
def test_mesh_apply_plain_matches_reference(k, kind):
    rng = np.random.default_rng(k)
    jspec, tspec = jun.mesh_spec(k, kind), tun.mesh_spec(k, kind)
    ph = rng.uniform(-np.pi, np.pi, jspec.n_rot).astype(np.float32)
    d = rng.choice([-1.0, 1.0], k).astype(np.float32)
    x = rng.standard_normal((24, k)).astype(np.float32)
    yj = ops.mesh_apply(jspec, jnp.asarray(ph), jnp.asarray(x),
                        jnp.asarray(d))
    yt = mesh_apply(tspec, torch.from_numpy(ph), torch.from_numpy(x),
                    torch.from_numpy(d))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


@pytest.mark.parametrize("kind", ["clements", "reck"])
def test_mesh_apply_batched_is_one_mesh_per_entry(kind):
    """Block-batched: mesh b with its own phases and signs on rows x[b]."""
    k, b = 9, 4
    rng = np.random.default_rng(11)
    jspec, tspec = jun.mesh_spec(k, kind), tun.mesh_spec(k, kind)
    ph = rng.uniform(-np.pi, np.pi, (b, jspec.n_rot)).astype(np.float32)
    d = rng.choice([-1.0, 1.0], (b, k)).astype(np.float32)
    x = rng.standard_normal((b, 5, k)).astype(np.float32)
    yt = mesh_apply_batched(tspec, torch.from_numpy(ph), torch.from_numpy(x),
                            torch.from_numpy(d))
    yt_t = mesh_apply_batched(tspec, torch.from_numpy(ph), torch.from_numpy(x),
                              torch.from_numpy(d), transpose_out=True)
    for i in range(b):
        yj = np.asarray(ops.mesh_apply(jspec, jnp.asarray(ph[i]),
                                       jnp.asarray(x[i]), jnp.asarray(d[i])))
        np.testing.assert_allclose(yt[i].numpy(), yj, atol=1e-5)
        np.testing.assert_allclose(yt_t[i].numpy(), yj.T, atol=1e-5)
    # a leading 1 shares the rows across meshes
    shared = mesh_apply_batched(tspec, torch.from_numpy(ph),
                                torch.from_numpy(x[:1]), torch.from_numpy(d))
    np.testing.assert_allclose(
        shared[2].numpy(),
        np.asarray(ops.mesh_apply(jspec, jnp.asarray(ph[2]),
                                  jnp.asarray(x[0]), jnp.asarray(d[2]))),
        atol=1e-5)


def test_mesh_apply_rejects_bad_inputs():
    spec = tun.mesh_spec(4, "clements")
    ph = torch.zeros(3, spec.n_rot)
    x = torch.zeros(3, 2, 4)
    with pytest.raises(ValueError):
        mesh_apply_batched(spec, ph[:, :-1], x)
    with pytest.raises(ValueError):
        mesh_apply_batched(spec, ph, torch.zeros(2, 2, 4))
    with pytest.raises(TypeError):
        mesh_apply_batched(spec, ph.double(), x)
    with pytest.raises(ValueError):
        mesh_apply_batched(spec, ph.to("meta"), x.to("meta"))
