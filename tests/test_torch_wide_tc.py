"""The tensor-core routes (``"wide_tc"``) of ``ptc_block_matmul`` and
``sigma_grad``: their rule, and their roundings against the reference.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against their plain versions); here, on
the CPU:

* The route rule: bf16 operands at k 64 and 128 take ``"wide_tc"`` in
  both wrappers; fp32 at other k > 32 (33, 100), bf16 at other k > 32
  (33, 100, 192) and calls that name no dtype take ``"wide"`` (fp32 at k
  64 and 128: ``tests/test_torch_3xtf32.py``); k <= 32 is unchanged by
  the dtype.  The new counters share one library.
* Both wrappers refuse ``force_route="wide_tc"`` where it cannot serve:
  fp32 operands, k = 100, a CPU tensor.  On a CPU tensor they run their
  plain versions whatever the route would be on a card.
* A plain-PyTorch emulation of the route's roundings
  (``ref.ptc_block_matmul_tc_ref``, ``ref.sigma_grad_tc_ref``) at k 64 and
  128, P and Q 2-3, T 192 (a 128-row tile and a ragged one), held
  against the reference package's blocked ``ptc_linear`` on the same
  bf16-valued inputs, run in float32 (the suite runs JAX with x64 on):
  y within 2^-7 of its largest entry (U diag(s), W and y each rounded
  once to bf16); ds within 1e-4, with and without a column mask drawn by
  the reference's ``column_mask`` at α_C = 0.6 and ``column_norm="exp"``
  (a normalizer off bf16's grid, split into bf16 hi + lo after the fp32
  product); and the least-squares scale of ds against the reference's
  within 5e-4 of 1, the check that caught a column scale rounded to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptc as jptc, subspace as jsub
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro_torch.kernels import build, ptc_block_matmul, ref, sigma_grad
from repro_torch.kernels.ptc_block_matmul import (MAX_K, ROUTES, TC_K,
                                                  TC_TILE, WIDE_TILE, route,
                                                  tc_ok)
from repro_torch.kernels.sigma_grad import ROUTES as SIGMA_ROUTES
from repro_torch.kernels.sigma_grad import route as sigma_route

B16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("t,q", [(1, 1), (100, 3), (4096, 16)])
def test_bf16_at_k_64_and_128_takes_the_tensor_cores(k, t, q):
    assert tc_ok(k, B16)
    assert route(t, 64, q, k, B16) == "wide_tc"
    assert sigma_route(k, B16) == "wide_tc"


@pytest.mark.parametrize("k,dtype", [(33, F32), (100, F32), (33, B16),
                                     (100, B16), (192, B16), (256, B16),
                                     (64, None), (128, None)])
def test_other_wide_calls_stay_on_the_cuda_cores(k, dtype):
    assert not tc_ok(k, dtype)
    for t, q in ((1, 1), (129, 2), (4096, 16)):
        assert route(t, 64, q, k, dtype) == "wide"
    assert sigma_route(k, dtype) == "wide"


@pytest.mark.parametrize("k", [4, 8, 9, 16, 32])
@pytest.mark.parametrize("dtype", [F32, B16])
def test_dtype_changes_no_route_up_to_32(k, dtype):
    for t, q in ((9, 1), (128, 1), (129, 1), (32, 456)):
        assert route(t, 57, q, k, dtype) == route(t, 57, q, k)
        assert route(t, 57, q, k, dtype) in ("product", "per_block")
    assert sigma_route(k, dtype) == "narrow"


def test_tensor_core_counters_share_one_library():
    assert TC_K == (64, 128) and all(k > MAX_K for k in TC_K)
    assert ROUTES["wide_tc"] == "ptc_block_matmul_wide_tc"
    assert SIGMA_ROUTES == {"narrow": "sigma_grad", "wide": "sigma_grad_wide",
                            "wide_tc": "sigma_grad_wide_tc",
                            "wide_3xtf32": "sigma_grad_wide_3xtf32"}
    for name in ("ptc_block_matmul_wide_tc", "sigma_grad_wide_tc"):
        assert build.KERNELS[name] == "ptc_wide_tc"
        assert name in build.launch_counts
    assert build.SOURCES["ptc_wide_tc"] == "ptc_wide_tc.cu"
    # the CUDA-core and tensor-core products tile T alike: the wrappers
    # check both grids by wide_plan
    assert TC_TILE[0] == WIDE_TILE[0]


def _operands(t, p, q, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((t, q * k), (p, q, k, k), (p, q, k), (p, q, k, k), (t, p * k))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


@pytest.mark.parametrize("k,dtype,why", [
    (128, F32, "no route"),           # fp32: the bf16 products miss 1e-4
    (100, B16, "no route"),           # k outside TC_K
    (64, B16, "CUDA tensor only"),    # a CPU tensor: no tensor cores
    (128, B16, "CUDA tensor only"),
])
def test_wrappers_refuse_wide_tc_where_it_cannot_serve(k, dtype, why):
    x, u, s, v, dy = _operands(8, 2, 2, k, dtype)
    col = torch.ones(8)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match=why):
        ptc_block_matmul(x, u, s, v, force_route="wide_tc")
    with pytest.raises(ValueError, match=why):
        sigma_grad(dy, x, u, v, col, force_route="wide_tc")
    assert build.launch_counts == before


@pytest.mark.parametrize("k", [64, 128])
def test_cpu_tensors_run_the_plain_versions(k):
    x, u, s, v, dy = _operands(20, 2, 3, k, B16)
    col = (torch.arange(20) % 3 != 0).float() / 0.6
    before = dict(build.launch_counts)
    assert torch.equal(ptc_block_matmul(x, u, s, v),
                       ref.ptc_block_matmul_ref(x, u, s, v))
    assert torch.equal(sigma_grad(dy, x, u, v, col),
                       ref.sigma_grad_ref(dy, x, u, v, col))
    assert build.launch_counts == before
    # the route a card would take, forced to the CUDA cores: the same
    assert torch.equal(ptc_block_matmul(x, u, s, v, force_route="wide"),
                       ref.ptc_block_matmul_ref(x, u, s, v))


def test_split_bf16_keeps_17_bits():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         * np.float32(32 / 19))
    hi, lo = ref.split_bf16(a)
    assert hi.dtype == lo.dtype == B16
    err = (hi.float() + lo.float() - a).abs()
    assert bool((err <= a.abs() * 2.0 ** -17).all())
    assert torch.equal(hi.float(), a.to(B16).float())


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


# (P, Q, k); T = 192: one 128-row tile and a ragged one of 64
TC_GEOMETRIES = [(2, 3, 64), (3, 2, 64), (2, 2, 128), (3, 2, 128),
                 (2, 3, 128)]


@pytest.mark.parametrize("p,q,k", TC_GEOMETRIES)
@pytest.mark.parametrize("column", [None, "exp"])
def test_tensor_core_roundings_match_reference_blocked_linear(p, q, k,
                                                              column):
    t = 192
    x, u, s, v, dy = _operands(t, p, q, k, B16, seed=p * 100 + q * 10 + k)
    # the reference in float32 on the same bf16 values
    pj = jptc.PTCParams(*(jnp.asarray(a.float().numpy(), jnp.float32)
                          for a in (u, s, v)))
    mj, col = None, None
    if column is not None:
        mj = jsub.sample_masks(jax.random.PRNGKey(k + p), pj, t,
                               JSparsityConfig(alpha_w=1.0, alpha_c=0.6,
                                               column_norm=column))
        col = torch.tensor(np.asarray(mj.column), dtype=F32)
        # the normalizer is off bf16's grid: one bf16 rounding of it (or
        # of col ⊙ δy) would bias ds
        scale = float(col.max())
        assert float(torch.tensor(scale).to(B16)) != scale
        assert int(torch.count_nonzero(col)) == round(0.6 * t)
    yj, vjp = jax.vjp(lambda xx, ss: jsub.ptc_linear(
        xx, jptc.PTCParams(pj.u, ss, pj.v), mj, mode="blocked"),
        jnp.asarray(x.float().numpy()), pj.s)
    _, dsj = vjp(jnp.asarray(dy.float().numpy()))
    yj, dsj = np.asarray(yj, np.float32), np.asarray(dsj, np.float32)

    y = ref.ptc_block_matmul_tc_ref(x, u, s, v)
    assert y.shape == (t, p * k) and y.dtype == B16
    assert _rel(y.float().numpy(), yj) < 2 ** -7
    ds = ref.sigma_grad_tc_ref(dy, x, u, v, col)
    assert ds.shape == (p, q, k) and ds.dtype == F32
    assert _rel(ds.numpy(), dsj) < 1e-4
    got = ds.numpy().ravel().astype(np.float64)
    want = dsj.ravel().astype(np.float64)
    assert abs(float(got @ want / (want @ want)) - 1.0) < 5e-4


@pytest.mark.parametrize("k", [64, 128])
def test_one_bf16_rounding_of_the_column_scale_would_miss(k):
    """The reason for the hi + lo split: rounding col ⊙ δy once to bf16
    moves ds by more than the 1e-4 the route is held to (under
    ``column_norm="exp"``, the normalizer 1/0.6 off bf16's grid)."""
    p, q, t = 2, 2, 192
    x, u, _, v, dy = _operands(t, p, q, k, B16, seed=k)
    col = torch.from_numpy(
        (np.random.default_rng(k).random(t) < 0.6).astype(np.float32)
        / np.float32(0.6))
    want = ref.sigma_grad_ref(dy, x, u, v, col)
    split = ref.sigma_grad_tc_ref(dy, x, u, v, col)
    once = ref.sigma_grad_ref((dy.float() * col[:, None]).to(B16), x, u, v)
    assert _rel(split.numpy(), want.numpy()) < 1e-5
    assert _rel(once.numpy(), want.numpy()) > 1e-4

