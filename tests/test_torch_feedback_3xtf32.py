"""The 3xTF32 route (``"wide_3xtf32"``) of ``feedback_matmul``: its rule,
its refusals, and its arithmetic against the reference.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against the fp32 plain version at 1e-5 of the
largest entry); here, on the CPU:

* The route rule: fp32 operands at k 64 and 128 take ``"wide_3xtf32"``;
  bf16 there keeps ``"wide_tc"``; other k > 32, and calls that name no
  dtype, keep ``"wide"``.  The new counter lives in the 3xTF32 library,
  beside the forward's and the Σ-gradient's.
* The wrapper refuses ``force_route="wide_3xtf32"`` where it cannot
  serve: a CPU tensor, bf16 operands, k outside 64 and 128.  On a CPU
  tensor it runs the fp32 plain version.
* ``ref.feedback_matmul_3xtf32_ref`` against ``repro.kernels.ops``'s
  feedback in interpret mode, both sides in float32, at k 64 and 128 with
  P·k up to 8,192 (olmo-1b's up projection's reduction), under masks of
  density 0, 0.5, 1 and btopk: within 1e-5 of the largest entry.  The
  same inputs with one lo term dropped (in the compose or in the
  product) read above 1e-5: the limit sees a missing term.
* A q row masked everywhere gives exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import build, feedback_matmul, ref
from repro_torch.kernels.feedback_matmul import ROUTES, route
from repro_torch.kernels.ptc_block_matmul import TC_K

B16, F32 = torch.bfloat16, torch.float32
LIMIT = 1e-5


@pytest.mark.parametrize("k", TC_K)
def test_fp32_at_k_64_and_128_takes_3xtf32(k):
    assert route(k, F32) == "wide_3xtf32"
    assert route(k, B16) == "wide_tc"


@pytest.mark.parametrize("k,dtype", [(33, F32), (100, F32), (192, F32),
                                     (256, F32), (64, None), (128, None),
                                     (33, B16), (100, B16)])
def test_other_wide_calls_keep_the_cuda_cores(k, dtype):
    assert route(k, dtype) == "wide"


def test_3xtf32_counter_lives_in_the_3xtf32_library():
    assert ROUTES["wide_3xtf32"] == "feedback_matmul_wide_3xtf32"
    assert build.KERNELS["feedback_matmul_wide_3xtf32"] == "ptc_wide_3xtf32"
    assert build.KERNELS["ptc_block_matmul_wide_3xtf32"] == "ptc_wide_3xtf32"
    assert "feedback_matmul_wide_3xtf32" in build.launch_counts


def _operands(t, p, q, k, dtype=F32, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((t, p * k), (p, q, k, k), (p, q, k), (p, q, k, k))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


def _mask(q, p, density, seed):
    """A feedback mask (Q, P) as the samplers scale it (kept blocks at
    1/0.6, off bf16's grid): density 0, 0.5 or 1 drawn per block, or
    "btopk", round(0.6·P) kept blocks in each of the Q rows."""
    rng = np.random.default_rng(seed)
    scale = np.float32(1 / 0.6)
    if density == "btopk":
        mask = np.zeros((q, p), np.float32)
        for row in mask:
            row[rng.permutation(p)[:max(1, round(0.6 * p))]] = scale
    else:
        mask = (rng.random((q, p)) < density).astype(np.float32) * scale
    return torch.from_numpy(mask)


@pytest.mark.parametrize("k,dtype,why", [
    (64, F32, "CUDA tensor only"),    # a CPU tensor: no tensor cores
    (128, F32, "CUDA tensor only"),
    (128, B16, "no route"),           # bf16 takes wide_tc
    (100, F32, "no route"),           # k outside TC_K
    (32, F32, "no route"),
])
def test_wrapper_refuses_3xtf32_where_it_cannot_serve(k, dtype, why):
    dy, u, s, v = _operands(8, 2, 2, k, dtype)
    mask = _mask(2, 2, "btopk", k)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match=why):
        feedback_matmul(dy, u, s, v, mask, force_route="wide_3xtf32")
    assert build.launch_counts == before


@pytest.mark.parametrize("k", TC_K)
def test_cpu_tensors_run_the_fp32_plain_version(k):
    dy, u, s, v = _operands(20, 3, 2, k, seed=k)
    mask = _mask(2, 3, "btopk", k)
    before = dict(build.launch_counts)
    want = ref.feedback_matmul_ref(dy, u, s, v, mask)
    assert torch.equal(feedback_matmul(dy, u, s, v, mask), want)
    assert torch.equal(feedback_matmul(dy, u, s, v, mask, force_route="wide"),
                       want)
    assert build.launch_counts == before


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


def _feedback(dy, u, s, v, mask, compose_terms, product_terms):
    p, q, k, _ = u.shape
    us = (u * s[:, :, None, :]) * mask.T[:, :, None, None]
    wt = _mm(v.transpose(-1, -2), us.transpose(-1, -2), compose_terms)
    return _mm(dy, wt.permute(0, 3, 1, 2).reshape(p * k, q * k),
               product_terms)


THREE = ("lh", "hl", "hh")
DROPPED = [(("hh",), ("hh",)), (THREE, ("hl", "hh")), (THREE, ("lh", "hh")),
           (("hl", "hh"), THREE)]

# (T, P, Q, k): P·k of 192 and 4,096 at k = 64, 384 and 8,192 (olmo-1b's
# up projection's reduction) at k = 128; Q odd
GEOMETRIES = [(16, 3, 3, 64), (12, 64, 2, 64), (16, 3, 3, 128),
              (8, 64, 1, 128)]


@pytest.mark.parametrize("t,p,q,k", GEOMETRIES)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0, "btopk"])
def test_feedback_3xtf32_matches_reference(t, p, q, k, density):
    dy, u, s, v = _operands(t, p, q, k, seed=t * 1000 + p * 10 + k)
    mask = _mask(q, p, density, seed=p + q + k)
    dxj = np.asarray(ops.feedback_matmul(
        *(jnp.asarray(a.numpy(), jnp.float32) for a in (dy, u, s, v, mask))))
    dx = ref.feedback_matmul_3xtf32_ref(dy, u, s, v, mask)
    assert dx.shape == (t, q * k) and dx.dtype == F32
    assert torch.equal(dx, _feedback(dy, u, s, v, mask, THREE, THREE))
    if density == 0.0:
        assert int(torch.count_nonzero(dx)) == 0
        assert not np.any(dxj)
        return
    assert _rel(dx.numpy(), dxj) < LIMIT
    # a dropped lo term (one pass; or one of the two lo products of the
    # product or of the compose) is seen
    for compose_terms, product_terms in DROPPED:
        worse = _feedback(dy, u, s, v, mask, compose_terms, product_terms)
        assert _rel(worse.numpy(), dxj) > LIMIT, (compose_terms,
                                                  product_terms)


@pytest.mark.parametrize("k", TC_K)
def test_a_q_block_masked_everywhere_gives_exact_zeros(k):
    p, q, t = 3, 3, 70
    dy, u, s, v = _operands(t, p, q, k, seed=k + 5)
    mask = _mask(q, p, "btopk", k)
    mask[1] = 0.0                        # q block 1 keeps no p block
    dx = ref.feedback_matmul_3xtf32_ref(dy, u, s, v, mask)
    assert int(torch.count_nonzero(dx[:, k:2 * k])) == 0
    assert int(torch.count_nonzero(dx[:, :k])) > 0
    assert int(torch.count_nonzero(dx[:, 2 * k:])) > 0
