"""The 3xTF32 routes (``"wide_3xtf32"``) of ``ptc_block_matmul`` and
``sigma_grad``: their rule, and their arithmetic against the reference.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold them against the fp32 plain versions at 1e-5 of
the largest entry); here, on the CPU:

* The route rule: fp32 operands at k 64 and 128 take ``"wide_3xtf32"`` in
  ``ptc_block_matmul`` (T 1, 100, 4096; Q 1, 3, 16), ``sigma_grad`` and
  ``feedback_matmul``; bf16 there keeps ``"wide_tc"``; fp32 at other
  k > 32, and calls that name no dtype, keep ``"wide"``.  The three
  counters share one library of their own (the feedback's own tests are
  in ``tests/test_torch_feedback_3xtf32.py``).
* Both wrappers refuse ``force_route="wide_3xtf32"`` where it cannot
  serve: a CPU tensor, bf16 operands, k other than 64 and 128.  On a CPU
  tensor they run their fp32 plain versions.
* ``ref.split_tf32``: hi has its low 13 bits zero, hi + lo reproduces a
  within 2^-22 of |a|, and hi rounds to nearest with ties away from zero,
  checked against a numpy version and the nearest grid value at values
  with hand-set bits.
* ``ref.ptc_block_matmul_3xtf32_ref`` and ``ref.sigma_grad_3xtf32_ref``
  (with and without a column scale off bf16's grid) against
  ``repro.kernels.ops`` in interpret mode, both sides in float32, at k 64
  and 128 and K = Q·k up to 2048: within 1e-5 of the largest entry.  The
  same inputs with a lo term dropped (one pass, hi·hi only; or one of the
  two lo products) read above 1e-5: the limit sees a missing term.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import build, ptc_block_matmul, ref, sigma_grad
from repro_torch.kernels.feedback_matmul import ROUTES as FEEDBACK_ROUTES
from repro_torch.kernels.feedback_matmul import route as feedback_route
from repro_torch.kernels.ptc_block_matmul import (MAX_K, ROUTES, TC_K,
                                                  TF32X3_TILE, WIDE_TILE,
                                                  route, tc_ok, tf32x3_ok)
from repro_torch.kernels.sigma_grad import ROUTES as SIGMA_ROUTES
from repro_torch.kernels.sigma_grad import route as sigma_route

B16, F32 = torch.bfloat16, torch.float32
LIMIT = 1e-5


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("t", [1, 100, 4096])
@pytest.mark.parametrize("q", [1, 3, 16])
def test_fp32_at_k_64_and_128_takes_3xtf32(k, t, q):
    assert tf32x3_ok(k, F32) and not tc_ok(k, F32)
    assert route(t, 64, q, k, F32) == "wide_3xtf32"
    assert sigma_route(k, F32) == "wide_3xtf32"
    assert feedback_route(k, F32) == "wide_3xtf32"


@pytest.mark.parametrize("k,dtype,want", [
    (64, B16, "wide_tc"), (128, B16, "wide_tc"),
    (33, F32, "wide"), (100, F32, "wide"), (192, F32, "wide"),
    (256, F32, "wide"), (64, None, "wide"), (128, None, "wide"),
    (33, B16, "wide"), (100, B16, "wide")])
def test_other_wide_calls_keep_their_routes(k, dtype, want):
    assert not tf32x3_ok(k, dtype)
    for t, q in ((1, 1), (129, 2), (4096, 16)):
        assert route(t, 64, q, k, dtype) == want
    assert sigma_route(k, dtype) == want
    assert feedback_route(k, dtype) == ("wide_tc" if want == "wide_tc"
                                        else "wide")


@pytest.mark.parametrize("k", [4, 9, 16, 32])
def test_fp32_up_to_32_keeps_the_narrow_routes(k):
    assert not tf32x3_ok(k, F32)
    for t, q in ((9, 1), (4096, 16)):
        assert route(t, 57, q, k, F32) == route(t, 57, q, k)
    assert sigma_route(k, F32) == "narrow"


def test_3xtf32_counters_share_one_library():
    assert TC_K == (64, 128) and all(k > MAX_K for k in TC_K)
    assert ROUTES["wide_3xtf32"] == "ptc_block_matmul_wide_3xtf32"
    assert SIGMA_ROUTES["wide_3xtf32"] == "sigma_grad_wide_3xtf32"
    assert FEEDBACK_ROUTES["wide_3xtf32"] == "feedback_matmul_wide_3xtf32"
    for name in ("ptc_block_matmul_wide_3xtf32", "sigma_grad_wide_3xtf32",
                 "feedback_matmul_wide_3xtf32"):
        assert build.KERNELS[name] == "ptc_wide_3xtf32"
        assert name in build.launch_counts
    assert build.SOURCES["ptc_wide_3xtf32"] == "ptc_wide_3xtf32.cu"
    # the wrappers check the grids by wide_plan: the row tiles agree
    assert TF32X3_TILE[0] == WIDE_TILE[0]


def _operands(t, p, q, k, dtype=F32, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((t, q * k), (p, q, k, k), (p, q, k), (p, q, k, k), (t, p * k))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


@pytest.mark.parametrize("k,dtype,why", [
    (64, F32, "CUDA tensor only"),    # a CPU tensor: no tensor cores
    (128, F32, "CUDA tensor only"),
    (128, B16, "no route"),           # bf16 takes wide_tc
    (100, F32, "no route"),           # k outside TC_K
    (32, F32, "no route"),
])
def test_wrappers_refuse_3xtf32_where_it_cannot_serve(k, dtype, why):
    x, u, s, v, dy = _operands(8, 2, 2, k, dtype)
    col = torch.ones(8)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match=why):
        ptc_block_matmul(x, u, s, v, force_route="wide_3xtf32")
    with pytest.raises(ValueError, match=why):
        sigma_grad(dy, x, u, v, col, force_route="wide_3xtf32")
    with pytest.raises(ValueError, match=why):
        sigma_grad(dy, x, u, v, force_route="wide_3xtf32")
    assert build.launch_counts == before


@pytest.mark.parametrize("k", [64, 128])
def test_cpu_tensors_run_the_fp32_plain_versions(k):
    x, u, s, v, dy = _operands(20, 2, 3, k)
    col = (torch.arange(20) % 3 != 0).float() / 0.6
    before = dict(build.launch_counts)
    assert torch.equal(ptc_block_matmul(x, u, s, v),
                       ref.ptc_block_matmul_ref(x, u, s, v))
    assert torch.equal(sigma_grad(dy, x, u, v, col),
                       ref.sigma_grad_ref(dy, x, u, v, col))
    assert torch.equal(sigma_grad(dy, x, u, v, force_route="wide"),
                       ref.sigma_grad_ref(dy, x, u, v))
    assert build.launch_counts == before


def _split_np(a):
    """numpy's split: add 0x1000 to the bits, clear the low 13."""
    def rna(b):
        bits = np.asarray(b, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
            .view(np.float32)
    hi = rna(a)
    return hi, rna(np.asarray(a, np.float32) - hi)


def _nearest_tf32_away(a):
    """The tf32 value nearest a (float64 arithmetic), ties away from 0."""
    out = []
    for val in np.asarray(a, np.float64):
        _, e = np.frexp(abs(val))               # |val| = m 2^e, m in [0.5, 1)
        step = 2.0 ** (e - 11)                  # tf32: 11 significant bits
        lo = np.floor(abs(val) / step) * step
        hi = lo + step
        pick = hi if abs(val) - lo >= hi - abs(val) else lo
        out.append(np.copysign(pick, val))
    return np.asarray(out, np.float32)


def test_split_tf32_hi_lo_and_rounding():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))) \
        .astype(np.float32)
    hi, lo = ref.split_tf32(torch.from_numpy(a))
    assert hi.dtype == lo.dtype == F32
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    err = (hi.double() + lo.double() - torch.from_numpy(a).double()).abs()
    assert bool((err <= torch.from_numpy(np.abs(a)).double()
                 * 2.0 ** -22).all())
    nh, nl = _split_np(a)
    assert np.array_equal(hi.numpy(), nh) and np.array_equal(lo.numpy(), nl)
    # hand-set bits: ties (low 13 bits 0x1000) of both signs round away
    # from zero, neighbours of a tie round to the nearer value, and a tie
    # at the top of the significand carries into the exponent
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0xBF800FFF,
                     0x3F801001, 0xBF801001, 0x3FFFF000, 0xBFFFF000,
                     0x3F803000, 0x00001000, 0x4B7FF000], np.uint32)
    vals = bits.view(np.float32)
    hi, _ = ref.split_tf32(torch.from_numpy(vals))
    assert np.array_equal(hi.numpy(), _split_np(vals)[0])
    normal = np.abs(vals) >= np.finfo(np.float32).tiny   # 0x1000: subnormal
    assert np.array_equal(hi.numpy()[normal],
                          _nearest_tf32_away(vals[normal]))
    want_bits = [0x3F802000, 0xBF802000, 0x3F800000, 0xBF800000, 0x3F802000,
                 0xBF802000, 0x40000000, 0xC0000000, 0x3F804000, 0x00002000,
                 0x4B800000]
    assert hi.numpy().view(np.uint32).tolist() == want_bits


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


def _mm(a, b, terms):
    """a @ b over the named products of the tf32 splits ("lh": lo_a hi_b,
    "hl", "hh"), summed in fp32."""
    (ah, al), (bh, bl) = ref.split_tf32(a), ref.split_tf32(b)
    parts = {"lh": lambda: al @ bh, "hl": lambda: ah @ bl,
             "hh": lambda: ah @ bh}
    return sum(parts[n]() for n in terms)


def _forward(x, u, s, v, compose_terms, product_terms):
    p, q, k, _ = u.shape
    w = _mm(u * s[:, :, None, :], v, compose_terms)
    w = w.permute(0, 2, 1, 3).reshape(p * k, q * k)
    return _mm(x, w.T, product_terms)


THREE = ("lh", "hl", "hh")
DROPPED = [(("hh",), ("hh",)), (THREE, ("hl", "hh")), (THREE, ("lh", "hh"))]

# (T, P, Q, k): K = Q·k of 192, 2048 at k = 64 and 384, 2048 at k = 128
FWD_GEOMETRIES = [(16, 2, 3, 64), (20, 3, 32, 64), (16, 3, 3, 128),
                  (16, 2, 16, 128)]


@pytest.mark.parametrize("t,p,q,k", FWD_GEOMETRIES)
def test_forward_3xtf32_matches_reference(t, p, q, k):
    x, u, s, v, _ = _operands(t, p, q, k, seed=t * 1000 + q * 10 + k)
    yj = np.asarray(ops.ptc_block_matmul(
        *(jnp.asarray(a.numpy(), jnp.float32) for a in (x, u, s, v))))
    y = ref.ptc_block_matmul_3xtf32_ref(x, u, s, v)
    assert y.shape == (t, p * k) and y.dtype == F32
    assert _rel(y.numpy(), yj) < LIMIT
    assert torch.equal(y, _forward(x, u, s, v, THREE, THREE))
    # a dropped lo term (one pass; or one of the two lo products) is seen
    for compose_terms, product_terms in DROPPED:
        worse = _forward(x, u, s, v, compose_terms, product_terms)
        assert _rel(worse.numpy(), yj) > LIMIT, product_terms


# (T, P, Q, k): T ragged against the 32-row stage and the 128-row tile
SIGMA_GEOMETRIES = [(200, 3, 2, 64), (100, 2, 32, 64), (129, 2, 3, 128),
                    (200, 2, 16, 128)]


@pytest.mark.parametrize("t,p,q,k", SIGMA_GEOMETRIES)
@pytest.mark.parametrize("with_col", [False, True])
def test_sigma_3xtf32_matches_reference(t, p, q, k, with_col):
    x, u, _, v, dy = _operands(t, p, q, k, seed=t + 7 * p + q + k)
    col = None
    scaled = dy
    if with_col:
        # a column scale off bf16's grid (column_norm "exp" at alpha 0.6)
        keep = np.random.default_rng(t).random(t) < 0.6
        col = torch.from_numpy(keep.astype(np.float32) / np.float32(0.6))
        assert float(col.max().to(B16)) != float(col.max())
        scaled = dy * col[:, None]
    dsj = np.asarray(ops.sigma_grad(
        *(jnp.asarray(a.numpy(), jnp.float32) for a in (scaled, x, u, v))))
    ds = ref.sigma_grad_3xtf32_ref(dy, x, u, v, col)
    assert ds.shape == (p, q, k) and ds.dtype == F32
    assert _rel(ds.numpy(), dsj) < LIMIT
    got = ds.numpy().ravel().astype(np.float64)
    want = dsj.ravel().astype(np.float64)
    assert abs(float(got @ want / (want @ want)) - 1.0) < 5e-4
    # G on one pass (hi·hi only), or with one lo product dropped: seen
    for terms in (("hh",), ("hl", "hh"), ("lh", "hh")):
        g = _mm(scaled.T, x, terms).reshape(p, k, q, k).permute(0, 2, 1, 3)
        worse = (torch.einsum("pqai,pqab->pqib", u, g) * v).sum(-1)
        assert _rel(worse.numpy(), dsj) > LIMIT, terms
