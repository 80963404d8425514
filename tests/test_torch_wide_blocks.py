"""Port parity at the LM block size: k > 32 and bf16 through the blocked path.

On a CPU tensor the port's wrappers run their plain PyTorch versions (the
card's wide kernels are held against those in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``); the reference runs its Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` does.  Inputs come from a
numpy seed and are cast to float32 or bfloat16 explicitly on both sides,
because the suite runs JAX with x64 on.

* The plain ``ptc_block_matmul``, ``sigma_grad`` and ``feedback_matmul``
  at k = 33, 64 and 128 against ``repro.kernels.ops``: 1e-4 of the largest
  output in fp32 (the reference suite's limit; sums taken in another
  order).
* ``ptc_linear(mode="blocked")`` with bf16 x, U, Σ, V* and δy, at 18 → 18
  with k = 9 and at k = 128 over P, Q <= 3 (T = 32), with and without
  feedback and column masks: y, ds and dx within 6e-2 of the largest entry
  (the reference's bf16 limit, ``tests/test_kernels.py:24``: its einsums
  round to bf16 between the U and V* passes, the port widens to fp32), in
  the reference's dtypes.
* ``apply_ptc_linear`` with ``PTCLinearCfg(k=128, mode="blocked")``, bf16
  bases, fp32 Σ and x padded and cropped, masks passed into both: the
  same limit.
* ``build_unitary`` at k = 64 and 128, reck and clements, against
  ``repro.core.unitary.build_unitary``: 1e-5 absolute, the limit of
  ``tests/test_torch_unitary.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptc as jptc, subspace as jsub, unitary as jun
from repro.kernels import ops
from repro.models import layers as jlayers
from repro_torch.core import ptc as tptc, subspace as tsub, unitary as tun
from repro_torch.core.subspace import SubspaceMasks
from repro_torch.kernels import (build, feedback_matmul, ptc_block_matmul,
                                 sigma_grad)
from repro_torch.models import layers as tlayers

WIDE_K = [33, 64, 128]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("k", WIDE_K)
def test_ptc_block_matmul_plain_matches_reference_wide_k(k):
    t, p, q = 16, 2, 3
    rng = np.random.default_rng(k)
    arrs = (_normal(rng, t, q * k), _normal(rng, p, q, k, k),
            _normal(rng, p, q, k), _normal(rng, p, q, k, k))
    yj = ops.ptc_block_matmul(*(jnp.asarray(a, jnp.float32) for a in arrs))
    before = dict(build.launch_counts)
    yt = ptc_block_matmul(*(torch.from_numpy(a) for a in arrs))
    assert build.launch_counts == before     # the plain path launches nothing
    assert yt.shape == (t, p * k) and yt.dtype == torch.float32
    assert _rel(yt.numpy(), yj) < 1e-4


@pytest.mark.parametrize("k", WIDE_K)
def test_sigma_grad_plain_matches_reference_wide_k(k):
    t, p, q = 16, 3, 2
    rng = np.random.default_rng(100 + k)
    arrs = (_normal(rng, t, p * k), _normal(rng, t, q * k),
            _normal(rng, p, q, k, k), _normal(rng, p, q, k, k))
    dsj = ops.sigma_grad(*(jnp.asarray(a, jnp.float32) for a in arrs))
    dst = sigma_grad(*(torch.from_numpy(a) for a in arrs))
    assert dst.shape == (p, q, k) and dst.dtype == torch.float32
    assert _rel(dst.numpy(), dsj) < 1e-4


@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_feedback_matmul_plain_matches_reference_wide_k(k, density):
    t, p, q = 16, 3, 2
    rng = np.random.default_rng(200 + k)
    dy, u, s, v = (_normal(rng, t, p * k), _normal(rng, p, q, k, k),
                   _normal(rng, p, q, k), _normal(rng, p, q, k, k))
    mask = (rng.random((q, p)) < density).astype(np.float32) * 2.0
    args = (dy, u, s, v, mask)
    dxj = np.asarray(ops.feedback_matmul(*(jnp.asarray(a, jnp.float32)
                                           for a in args)))
    dxt = feedback_matmul(*(torch.from_numpy(a) for a in args))
    assert dxt.shape == (t, q * k) and dxt.dtype == torch.float32
    if density == 0.0:
        assert not dxt.any() and not dxj.any()
    else:
        assert _rel(dxt.numpy(), dxj) < 1e-4


def _bases(rng, p, q, k):
    """Orthogonal U, V* and Σ in (0.5, 1.5), as a mapped layer holds."""
    def orth(*lead):
        a = rng.standard_normal(lead + (k, k))
        return np.linalg.qr(a)[0].astype(np.float32)
    return orth(p, q), rng.uniform(0.5, 1.5, (p, q, k)).astype(np.float32), \
        orth(p, q)


def _masks(rng, p, q, t, which):
    """Feedback (Q, P) and column (T,) masks as the samplers scale them."""
    if which == "none":
        return None
    fb = (rng.random((q, p)) < 0.6).astype(np.float32) / 0.6
    col = (rng.random(t) < 0.6).astype(np.float32) / 0.6
    return fb, col


# (P, Q, k): the reference quickstart's 18 → 18 at k = 9, and LM blocks
BLOCKED_BF16 = [(2, 2, 9), (1, 1, 128), (2, 3, 128), (3, 2, 128)]


@pytest.mark.parametrize("p,q,k", BLOCKED_BF16)
@pytest.mark.parametrize("which", ["none", "fb+col"])
def test_blocked_ptc_linear_bf16_matches_reference(p, q, k, which):
    t = 32
    rng = np.random.default_rng(p * 100 + q * 10 + k)
    u, s, v = _bases(rng, p, q, k)
    x, dy = _normal(rng, t, q * k), _normal(rng, t, p * k)
    m = _masks(rng, p, q, t, which)
    bf = jnp.bfloat16

    mj = None if m is None else jsub.SubspaceMasks(
        jnp.asarray(m[0]), jnp.asarray(m[1]))
    uj, vj = jnp.asarray(u, bf), jnp.asarray(v, bf)
    yj, vjp = jax.vjp(lambda xx, ss: jsub.ptc_linear(
        xx, jptc.PTCParams(uj, ss, vj), mj, mode="blocked"),
        jnp.asarray(x, bf), jnp.asarray(s, bf))
    dxj, dsj = vjp(jnp.asarray(dy, bf))

    mt = None if m is None else SubspaceMasks(*(torch.from_numpy(a)
                                                for a in m))
    b16 = torch.bfloat16
    xt = torch.from_numpy(x).to(b16).requires_grad_()
    st = torch.from_numpy(s).to(b16).requires_grad_()
    yt = tsub.ptc_linear(xt, tptc.PTCParams(torch.from_numpy(u).to(b16), st,
                                            torch.from_numpy(v).to(b16)),
                         mt, mode="blocked")
    dxt, dst = torch.autograd.grad(yt, (xt, st),
                                   torch.from_numpy(dy).to(b16))
    for got, want in ((yt, yj), (dxt, dxj), (dst, dsj)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert _rel(got.detach().float().numpy(),
                    np.asarray(want.astype(jnp.float32))) < 6e-2


@pytest.mark.parametrize("which", ["none", "fb+col"])
def test_apply_ptc_linear_blocked_k128_bf16_matches_reference(which):
    """300 ← 200 at k = 128 (P = 3, Q = 2): x padded to 256 columns, y
    cropped to 300; fp32 Σ and x, bf16 bases, as ``init_ptc_linear``
    stores them."""
    t, d_in, d_out, k = 32, 200, 300, 128
    p, q = 3, 2
    rng = np.random.default_rng(7)
    u, s, v = _bases(rng, p, q, k)
    x, dy = _normal(rng, t, d_in), _normal(rng, t, d_out)
    m = _masks(rng, p, q, t, which)

    pj = {"u": jnp.asarray(u, jnp.bfloat16), "s": jnp.asarray(s),
          "v": jnp.asarray(v, jnp.bfloat16)}
    mj = None if m is None else jsub.SubspaceMasks(
        jnp.asarray(m[0]), jnp.asarray(m[1]))
    cfg_j = jlayers.PTCLinearCfg(k=k, mode="blocked")
    yj, vjp = jax.vjp(lambda xx, ss: jlayers.apply_ptc_linear(
        dict(pj, s=ss), xx, cfg_j, mj, d_out=d_out),
        jnp.asarray(x), pj["s"])
    dxj, dsj = vjp(jnp.asarray(dy, yj.dtype))

    cfg_t = tlayers.PTCLinearCfg(k=k, mode="blocked")
    assert cfg_t.base_dtype == torch.bfloat16
    st = torch.from_numpy(s).requires_grad_()
    pt = {"u": torch.from_numpy(u).to(cfg_t.base_dtype), "s": st,
          "v": torch.from_numpy(v).to(cfg_t.base_dtype)}
    xt = torch.from_numpy(x).requires_grad_()
    mt = None if m is None else SubspaceMasks(*(torch.from_numpy(a)
                                                for a in m))
    yt = tlayers.apply_ptc_linear(pt, xt, cfg_t, mt, d_out=d_out)
    dxt, dst = torch.autograd.grad(yt, (xt, st),
                                   torch.from_numpy(dy).to(yt.dtype))
    assert yt.shape == (t, d_out)
    for got, want in ((yt, yj), (dxt, dxj), (dst, dsj)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert _rel(got.detach().float().numpy(),
                    np.asarray(want.astype(jnp.float32))) < 6e-2


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("kind", ["reck", "clements"])
def test_build_unitary_wide_k_matches_reference(k, kind):
    rng = np.random.default_rng(k)
    jspec, tspec = jun.mesh_spec(k, kind), tun.mesh_spec(k, kind)
    ph = rng.uniform(-np.pi, np.pi, (3, jspec.n_rot)).astype(np.float32)
    d = rng.choice([-1.0, 1.0], (3, k)).astype(np.float32)
    uj = np.asarray(jun.build_unitary(jspec, jnp.asarray(ph), jnp.asarray(d)))
    ut = tun.build_unitary(tspec, torch.from_numpy(ph), torch.from_numpy(d))
    assert ut.shape == (3, k, k) and ut.dtype == torch.float32
    np.testing.assert_allclose(ut.numpy(), uj, atol=1e-5)
    # orthogonal: the mesh is a product of rotations and signs
    eye = np.eye(k, dtype=np.float32)
    np.testing.assert_allclose(ut[0].numpy() @ ut[0].numpy().T, eye,
                               atol=1e-4)


@pytest.mark.parametrize("k", WIDE_K)
def test_no_wrapper_refuses_wide_k_or_bf16_on_cpu(k):
    rng = np.random.default_rng(k)
    t, p, q = 8, 2, 2
    b16 = torch.bfloat16
    x, dy = (torch.from_numpy(_normal(rng, t, n * k)).to(b16)
             for n in (q, p))
    u, v = (torch.from_numpy(_normal(rng, p, q, k, k)).to(b16)
            for _ in range(2))
    s = torch.from_numpy(_normal(rng, p, q, k)).to(b16)
    mask = torch.ones(q, p)
    assert ptc_block_matmul(x, u, s, v).dtype == b16
    assert sigma_grad(dy, x, u, v).dtype == torch.float32
    assert feedback_matmul(dy, u, s, v, mask).dtype == b16
    spec = tun.mesh_spec(k, "clements")
    ph = torch.zeros(2, spec.n_rot)
    assert torch.equal(tun.build_unitary(spec, ph), torch.eye(k).expand(
        2, k, k))
