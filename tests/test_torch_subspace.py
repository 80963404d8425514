"""Port parity: the in-situ subspace backward against the reference.

* ``sigma_grad`` and ``feedback_matmul`` (their plain versions, which the
  wrappers run on CPU tensors) against ``repro.kernels.ops``, whose Pallas
  kernels run in interpret mode as ``tests/test_kernels.py`` runs them:
  that file's geometries plus a ragged T, at its tolerances (1e-4 relative
  to the largest ds; 1e-4 absolute for dx).
* ``ptc_linear`` in both modes against ``repro.core.subspace.ptc_linear``:
  y, dx and ds under no masks, a feedback mask, a column mask, and both
  (the same masks handed to both packages), 1e-5 absolute (sums of 32
  rows of order-1 terms in fp32, taken in another order).
* ``ptc_linear`` (blocked and fused) in bf16 (x, U, Σ, V* and δy) against
  the reference under the same four mask settings: y, dx and ds within
  6e-2 of the largest entry (the reference's bf16 limit; its einsums
  round to bf16 between passes), in the reference's dtypes.
* Under bf16 the column mask scales δy in fp32: ds from bf16 operands
  with a normalizer bf16 cannot hold (``column_norm="exp"``), against the reference in fp32 on the
  same values, 1e-5 of the largest ds (the wrapper's fp32 result), and the
  least-squares scale of autograd's bf16 ds within 5e-4 of 1 (a bf16
  product scales it by 1.0020).
* The frozen bases get no gradient, and the kernel's ds is the autograd ds.
* The feedback wrapper's plan (compiled k, scratch row width, rows per
  lane) for the shapes the training path passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptc as jptc, subspace as jsub
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro.kernels import ops
from repro_torch import convert
from repro_torch.core import ptc as tptc, subspace as tsub
from repro_torch.kernels import build, feedback_matmul, ref, sigma_grad
from repro_torch.kernels.feedback_matmul import plan as feedback_plan


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("t,p,q,k", [(16, 2, 3, 8), (64, 4, 4, 16),
                                     (32, 1, 2, 9),
                                     (37, 3, 2, 9)])     # ragged T
def test_sigma_grad_plain_matches_reference(t, p, q, k):
    rng = np.random.default_rng(t + p)
    dy, x, u, v = (_f32(rng, t, p * k), _f32(rng, t, q * k),
                   _f32(rng, p, q, k, k), _f32(rng, p, q, k, k))
    dsj = np.asarray(ops.sigma_grad(*(jnp.asarray(a) for a in (dy, x, u, v))))
    before = dict(build.launch_counts)
    dst = sigma_grad(*(torch.from_numpy(a) for a in (dy, x, u, v)))
    assert build.launch_counts == before     # the plain path launches nothing
    assert dst.shape == (p, q, k) and dst.dtype == torch.float32
    scale = np.abs(dsj).max() + 1e-6
    assert np.abs(dst.numpy() - dsj).max() / scale < 1e-4


@pytest.mark.parametrize("t,p,q,k", [(16, 3, 2, 8), (32, 4, 4, 16),
                                     (8, 2, 2, 9),
                                     (37, 2, 3, 9)])     # ragged T
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0])
def test_feedback_matmul_plain_matches_reference(t, p, q, k, density):
    rng = np.random.default_rng(int(t + 10 * density))
    dy, u, s, v = (_f32(rng, t, p * k), _f32(rng, p, q, k, k),
                   _f32(rng, p, q, k), _f32(rng, p, q, k, k))
    mask = (rng.random((q, p)) < density).astype(np.float32) * 2.0
    args = (dy, u, s, v, mask)
    dxj = np.asarray(ops.feedback_matmul(*(jnp.asarray(a) for a in args)))
    dxt = feedback_matmul(*(torch.from_numpy(a) for a in args))
    assert dxt.shape == (t, q * k) and dxt.dtype == torch.float32
    np.testing.assert_allclose(dxt.numpy(), dxj, atol=1e-4)
    if density == 0.0:
        assert not dxt.any()


def test_wrappers_are_their_plain_versions_on_cpu_and_check_inputs():
    rng = np.random.default_rng(0)
    dy, x, u, s, v = (torch.from_numpy(a) for a in (
        _f32(rng, 8, 18), _f32(rng, 8, 27), _f32(rng, 2, 3, 9, 9),
        _f32(rng, 2, 3, 9), _f32(rng, 2, 3, 9, 9)))
    mask = torch.ones(3, 2)
    assert torch.equal(sigma_grad(dy, x, u, v), ref.sigma_grad_ref(dy, x, u, v))
    assert torch.equal(feedback_matmul(dy, u, s, v, mask),
                       ref.feedback_matmul_ref(dy, u, s, v, mask))
    with pytest.raises(TypeError):
        sigma_grad(dy.bfloat16(), x, u, v)
    with pytest.raises(TypeError):
        feedback_matmul(dy, u, s.double(), v, mask)
    with pytest.raises(ValueError):
        sigma_grad(dy, x[:, :-1], u, v)
    with pytest.raises(ValueError):
        feedback_matmul(dy, u, s, v, mask.T)
    with pytest.raises(ValueError):
        sigma_grad(dy.T.contiguous().T, x, u, v)


@pytest.mark.parametrize("t,k,want", [
    (1024, 9, (9, 12, 8)),       # FC W1 of VGG-8: 256-row tiles
    (32768, 9, (9, 12, 8)),      # conv l1
    (32, 9, (9, 12, 1)),         # a batch-32 FC layer: one 32-row tile
    (37, 13, (16, 16, 2)),       # k = 13 runs the k = 16 kernel
    (1000, 13, (16, 16, 4)),
    (129, 32, (32, 32, 2)),      # k = 32: at most 2 rows per lane
    (100, 4, (4, 4, 4)),
    (8, 8, (8, 8, 1)),
    (1, 1, (4, 4, 1)),
])
def test_feedback_plan_picks_kernel_k_scratch_width_and_rows(t, k, want):
    kt, kp, rt = feedback_plan(t, k)
    assert (kt, kp, rt) == want
    assert kt >= k and kp % 4 == 0 and kp >= kt
    assert rt in (1, 2, 4, 8) and (32 * rt < 2 * t or rt == 1)


def test_feedback_plan_rejects_k_past_the_widest_kernel():
    with pytest.raises(ValueError, match="outside"):
        feedback_plan(64, 33)
    with pytest.raises(ValueError, match="outside"):
        feedback_plan(64, 0)


@pytest.fixture(scope="module")
def layer():
    """A 36 × 27 weight at k = 9 (P = 4, Q = 3), 32 tokens, and a δy."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((36, 27)) * 0.2, jnp.float32)
    pj = jptc.svd_factorize(w, 9)
    pj = jptc.PTCParams(*(jnp.asarray(a, jnp.float32) for a in pj))
    x = _f32(rng, 32, 27)
    dy = _f32(rng, 32, 36)
    return pj, x, dy


def _masks(which, pj, n_tokens):
    cfg = JSparsityConfig(alpha_w=0.5 if "fb" in which else 1.0,
                          alpha_c=0.5 if "col" in which else 1.0)
    if which == "none":
        return None
    return jsub.sample_masks(jax.random.PRNGKey(3), pj, n_tokens, cfg)


@pytest.mark.parametrize("mode", ["blocked", "fused"])
@pytest.mark.parametrize("which", ["none", "fb", "col", "fb+col"])
def test_ptc_linear_matches_reference(layer, mode, which):
    pj, x, dy = layer
    mj = _masks(which, pj, x.shape[0])
    yj, vjp = jax.vjp(lambda xx, ss: jsub.ptc_linear(
        xx, jptc.PTCParams(pj.u, ss, pj.v), mj, mode=mode),
        jnp.asarray(x), pj.s)
    dxj, dsj = vjp(jnp.asarray(dy))

    pt = convert.ptc_params(pj)
    xt = torch.from_numpy(x).requires_grad_()
    st = pt.s.clone().requires_grad_()
    yt = tsub.ptc_linear(xt, tptc.PTCParams(pt.u, st, pt.v),
                         convert.subspace_masks(mj), mode=mode)
    dxt, dst = torch.autograd.grad(yt, (xt, st), torch.from_numpy(dy))
    for got, want in ((yt, yj), (dxt, dxj), (dst, dsj)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)


def _bf16_matches_reference(layer, which, mode):
    pj, x, dy = layer
    mj = _masks(which, pj, x.shape[0])
    bf = jnp.bfloat16
    uj, vj = pj.u.astype(bf), pj.v.astype(bf)
    yj, vjp = jax.vjp(lambda xx, ss: jsub.ptc_linear(
        xx, jptc.PTCParams(uj, ss, vj), mj, mode=mode),
        jnp.asarray(x, bf), pj.s.astype(bf))
    dxj, dsj = vjp(jnp.asarray(dy, bf))

    pt = convert.ptc_params(pj)
    b16 = torch.bfloat16
    xt = torch.from_numpy(x).to(b16).requires_grad_()
    st = pt.s.to(b16).requires_grad_()
    yt = tsub.ptc_linear(xt, tptc.PTCParams(pt.u.to(b16), st, pt.v.to(b16)),
                         convert.subspace_masks(mj), mode=mode)
    dxt, dst = torch.autograd.grad(yt, (xt, st),
                                   torch.from_numpy(dy).to(b16))
    for got, want in ((yt, yj), (dxt, dxj), (dst, dsj)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        want = np.asarray(want.astype(jnp.float32))
        err = np.abs(got.detach().float().numpy() - want).max()
        assert err / (np.abs(want).max() + 1e-6) < 6e-2


@pytest.mark.parametrize("which", ["none", "fb", "col", "fb+col"])
def test_blocked_ptc_linear_bf16_matches_reference(layer, which):
    _bf16_matches_reference(layer, which, "blocked")


@pytest.mark.parametrize("which", ["none", "fb", "col", "fb+col"])
def test_fused_ptc_linear_bf16_matches_reference(layer, which):
    """The fused backward with bf16 operands: the fp32 masks promote dW
    and the masked W to fp32, as the reference's do (a bf16 product
    against an fp32 operand raised before PR 28)."""
    _bf16_matches_reference(layer, which, "fused")


def test_backward_wrappers_take_bf16_operands_alike():
    rng = np.random.default_rng(1)
    dy, x, u, s, v = (torch.from_numpy(a).bfloat16() for a in (
        _f32(rng, 8, 18), _f32(rng, 8, 27), _f32(rng, 2, 3, 9, 9),
        _f32(rng, 2, 3, 9), _f32(rng, 2, 3, 9, 9)))
    mask = torch.ones(3, 2)
    ds = sigma_grad(dy, x, u, v)
    assert ds.dtype == torch.float32
    assert torch.equal(ds, ref.sigma_grad_ref(dy, x, u, v))
    dx = feedback_matmul(dy, u, s, v, mask)
    assert dx.dtype == torch.bfloat16
    assert torch.equal(dx, ref.feedback_matmul_ref(dy, u, s, v, mask))
    with pytest.raises(TypeError):           # operands alike, mask fp32
        feedback_matmul(dy, u, s, v, mask.bfloat16())
    with pytest.raises(TypeError):
        sigma_grad(dy, x.float(), u, v)


@pytest.mark.parametrize("k,p,q", [(9, 4, 3), (128, 2, 1)])
def test_blocked_column_scale_stays_fp32_under_bf16(k, p, q):
    """A column normalizer off bf16's grid (``column_norm="exp"``: 32/19 at
    α_C = 0.6, T = 32) scales δy in fp32, as the reference's ``gu *
    col_mask`` promotes; a bf16 product would scale every sampled
    Σ-gradient by 1.0020."""
    rng = np.random.default_rng(k)
    bf = torch.bfloat16
    dy, x, u, v = (torch.from_numpy(a).to(bf) for a in (
        _f32(rng, 32, p * k), _f32(rng, 32, q * k), _f32(rng, p, q, k, k),
        _f32(rng, p, q, k, k)))
    s = torch.from_numpy(_f32(rng, p, q, k)).to(bf)
    pj = jptc.PTCParams(*(jnp.asarray(a.float().numpy(), jnp.float32)
                          for a in (u, s, v)))
    mj = jsub.sample_masks(jax.random.PRNGKey(5), pj, 32,
                           JSparsityConfig(alpha_w=1.0, alpha_c=0.6,
                                           column_norm="exp"))
    col = torch.tensor(np.asarray(mj.column), dtype=torch.float32)
    scale = float(col.max())
    assert float(torch.tensor(scale).to(bf)) != scale
    # the reference in fp32 on the same bf16 values
    _, vjp = jax.vjp(lambda ss: jsub.ptc_linear(
        jnp.asarray(x.float().numpy()), jptc.PTCParams(pj.u, ss, pj.v), mj,
        mode="blocked"), pj.s)
    (dsj,) = vjp(jnp.asarray(dy.float().numpy()))
    dsj = np.asarray(dsj, np.float32)
    ds = sigma_grad(dy, x, u, v, col)
    assert np.abs(ds.numpy() - dsj).max() / np.abs(dsj).max() < 1e-5
    # through autograd: ds comes back in Σ's bf16, one rounding of it
    st = s.clone().requires_grad_()
    yt = tsub.ptc_linear(x, tptc.PTCParams(u, st, v),
                         tsub.SubspaceMasks(None, col), mode="blocked")
    (dst,) = torch.autograd.grad(yt, (st,), dy)
    assert torch.equal(dst, ds.to(bf))
    got = dst.float().numpy().ravel()
    ratio = float(got @ dsj.ravel() / (dsj.ravel() @ dsj.ravel()))
    assert abs(ratio - 1.0) < 5e-4


@pytest.mark.parametrize("mode", ["blocked", "fused"])
def test_frozen_bases_get_no_gradient(layer, mode):
    pj, x, _ = layer
    pt = convert.ptc_params(pj)
    u, v = pt.u.clone().requires_grad_(), pt.v.clone().requires_grad_()
    y = tsub.ptc_linear(torch.from_numpy(x), tptc.PTCParams(u, pt.s, v),
                        mode=mode)
    y.sum().backward()
    assert u.grad is None and v.grad is None


def test_first_layer_launches_no_feedback(layer, monkeypatch):
    """Without an input that needs a gradient the feedback pass is not run."""
    pj, x, dy = layer
    pt = convert.ptc_params(pj)
    calls = []
    monkeypatch.setattr(tsub, "feedback_matmul",
                        lambda *a: calls.append(1) or feedback_matmul(*a))
    st = pt.s.clone().requires_grad_()
    y = tsub.ptc_linear(torch.from_numpy(x), tptc.PTCParams(pt.u, st, pt.v),
                        mode="blocked")
    y.backward(torch.from_numpy(dy))
    assert not calls and st.grad is not None


def test_sigma_grad_matches_autograd(layer):
    """The kernel's ds is what plain autograd gives through the recomposed
    weight (dense, no sampling)."""
    pj, x, dy = layer
    pt = convert.ptc_params(pj)
    st = pt.s.clone().requires_grad_()
    y = tsub.ptc_linear_ref(torch.from_numpy(x),
                            tptc.PTCParams(pt.u, st, pt.v))
    (ds_autograd,) = torch.autograd.grad(y, st, torch.from_numpy(dy))
    ds = sigma_grad(torch.from_numpy(dy), torch.from_numpy(x), pt.u, pt.v)
    np.testing.assert_allclose(ds.numpy(), ds_autograd.numpy(), atol=1e-4)


def test_sample_masks_shapes_and_balance(layer):
    pj, _, _ = layer
    pt = convert.ptc_params(pj)
    from repro_torch.core.sparsity import SparsityConfig
    cfg = SparsityConfig(alpha_w=0.5, alpha_c=0.25)
    m = tsub.sample_masks(torch.Generator().manual_seed(0), pt, 32, cfg)
    assert m.feedback.shape == (3, 4) and m.column.shape == (32,)
    assert ((m.feedback > 0).sum(-1) == 2).all()
    assert int((m.column > 0).sum()) == 8
    dense = tsub.sample_masks(None, pt, 32, SparsityConfig())
    assert dense.feedback is None and dense.column is None
