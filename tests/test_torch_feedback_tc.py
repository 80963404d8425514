"""The tensor-core route (``"wide_tc"``) of ``feedback_matmul``: its rule,
its refusals, and its roundings against the reference.

The kernel itself runs only on a card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold it against its plain version); here, on the CPU:

* The route rule: bf16 operands at k 64 and 128 take ``"wide_tc"``; fp32
  there takes ``"wide_3xtf32"`` (``tests/test_torch_feedback_3xtf32.py``);
  fp32 and bf16 at other k > 32 and calls that name no dtype take
  ``"wide"``; k <= 32 takes ``"narrow"`` whatever the dtype.  The new
  counter lives in the tensor-core library.
* The wrapper refuses ``force_route="wide_tc"`` where it cannot serve:
  fp32 operands, k = 100, a CPU tensor; on a CPU tensor it runs the plain
  version whatever the route would be on a card.
* A plain-PyTorch emulation of the route's roundings
  (``ref.feedback_matmul_tc_ref``) at the tensor-core geometries of
  ``tests/test_torch_wide_tc.py``, T 192, held against dx of the
  reference package's blocked ``ptc_linear`` (its VJP) on the same
  bf16-valued inputs, run in float32, under feedback masks drawn by the
  reference's ``sample_masks`` (btopk at α_W = 0.6): within 2^-7 of the
  largest entry (U diag(s) mask, W̃ and dx each rounded once to bf16).
* A q block that the mask keeps nowhere gives an exact zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ptc as jptc, subspace as jsub
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro_torch.kernels import build, feedback_matmul, ref
from repro_torch.kernels.feedback_matmul import ROUTES, route
from repro_torch.kernels.ptc_block_matmul import MAX_K, TC_K

B16, F32 = torch.bfloat16, torch.float32
# (P, Q, k); T = 192, as the forward's and the Σ-gradient's roundings
TC_GEOMETRIES = [(2, 3, 64), (3, 2, 64), (2, 2, 128), (3, 2, 128),
                 (2, 3, 128)]


@pytest.mark.parametrize("k", TC_K)
def test_bf16_at_k_64_and_128_takes_the_tensor_cores(k):
    assert route(k, B16) == "wide_tc"


@pytest.mark.parametrize("k,dtype,want", [
    (33, F32, "wide"), (64, F32, "wide_3xtf32"), (100, F32, "wide"),
    (128, F32, "wide_3xtf32"), (33, B16, "wide"), (100, B16, "wide"),
    (192, B16, "wide"), (256, B16, "wide"), (64, None, "wide"),
    (128, None, "wide")])
def test_other_wide_calls_stay_on_the_cuda_cores(k, dtype, want):
    # fp32 at k 64 and 128 takes the tensor cores in 3xTF32; the rest the
    # CUDA cores
    assert route(k, dtype) == want


@pytest.mark.parametrize("k", [1, 4, 9, 13, 16, 32])
@pytest.mark.parametrize("dtype", [F32, B16, None])
def test_k_up_to_32_stays_narrow_whatever_the_dtype(k, dtype):
    assert k <= MAX_K
    assert route(k, dtype) == route(k) == "narrow"


@pytest.mark.parametrize("k", [33, 64, 100, 128, 256])
def test_route_without_a_dtype_is_unchanged(k):
    assert route(k) == "wide"


def test_tensor_core_counter_lives_in_the_tensor_core_library():
    assert ROUTES == {"narrow": "feedback_matmul",
                      "wide": "feedback_matmul_wide",
                      "wide_tc": "feedback_matmul_wide_tc",
                      "wide_3xtf32": "feedback_matmul_wide_3xtf32"}
    assert build.KERNELS["feedback_matmul_wide_tc"] == "ptc_wide_tc"
    assert build.KERNELS["feedback_matmul_wide"] == "ptc_wide"
    assert "feedback_matmul_wide_tc" in build.launch_counts


def _operands(t, p, q, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((t, p * k), (p, q, k, k), (p, q, k), (p, q, k, k))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype) for s in shapes]


def _btopk_mask(q, p, seed):
    """A btopk mask at α_W = 0.6 as the sampler scales it: round(0.6·P)
    kept blocks in each of the Q rows, each at 1/0.6 (off bf16's grid)."""
    rng = np.random.default_rng(seed)
    keep = max(1, round(0.6 * p))
    mask = np.zeros((q, p), np.float32)
    for row in mask:
        row[rng.permutation(p)[:keep]] = np.float32(1 / 0.6)
    return torch.from_numpy(mask)


@pytest.mark.parametrize("k,dtype,why", [
    (128, F32, "no route"),           # fp32: the bf16 products miss 1e-4
    (100, B16, "no route"),           # k outside TC_K
    (9, B16, "no route"),             # k <= 32: the narrow kernel
    (64, B16, "CUDA tensor only"),    # a CPU tensor: no tensor cores
    (128, B16, "CUDA tensor only"),
])
def test_wrapper_refuses_wide_tc_where_it_cannot_serve(k, dtype, why):
    dy, u, s, v = _operands(8, 2, 2, k, dtype)
    mask = _btopk_mask(2, 2, k)
    before = dict(build.launch_counts)
    with pytest.raises(ValueError, match=why):
        feedback_matmul(dy, u, s, v, mask, force_route="wide_tc")
    assert build.launch_counts == before


@pytest.mark.parametrize("k", TC_K)
@pytest.mark.parametrize("dtype", [F32, B16])
def test_cpu_tensors_run_the_plain_version(k, dtype):
    dy, u, s, v = _operands(20, 3, 2, k, dtype, seed=k)
    mask = _btopk_mask(2, 3, k)
    before = dict(build.launch_counts)
    want = ref.feedback_matmul_ref(dy, u, s, v, mask)
    assert torch.equal(feedback_matmul(dy, u, s, v, mask), want)
    # the route a card would take for bf16, forced to the CUDA cores: the
    # same plain version
    assert torch.equal(feedback_matmul(dy, u, s, v, mask, force_route="wide"),
                       want)
    assert build.launch_counts == before


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("p,q,k", TC_GEOMETRIES)
def test_tensor_core_roundings_match_reference_feedback(p, q, k):
    t = 192
    dy, u, s, v = _operands(t, p, q, k, B16, seed=p * 100 + q * 10 + k + 1)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (t, q * k)).astype(np.float32)).to(B16)
    # the reference in float32 on the same bf16 values, its masks drawn by
    # its own sampler: btopk at α_W = 0.6 keeps round(0.6·P) blocks a row
    pj = jptc.PTCParams(*(jnp.asarray(a.float().numpy(), jnp.float32)
                          for a in (u, s, v)))
    mj = jsub.sample_masks(jax.random.PRNGKey(p * 10 + q + k), pj, t,
                           JSparsityConfig(alpha_w=0.6,
                                           feedback_mode="btopk"))
    mask = torch.tensor(np.asarray(mj.feedback), dtype=F32)
    assert mask.shape == (q, p)
    assert int(torch.count_nonzero(mask)) == q * round(0.6 * p)
    _, vjp = jax.vjp(lambda xx: jsub.ptc_linear(xx, pj, mj, mode="blocked"),
                     jnp.asarray(x.float().numpy()))
    (dxj,) = vjp(jnp.asarray(dy.float().numpy()))
    dxj = np.asarray(dxj, np.float32)

    dx = ref.feedback_matmul_tc_ref(dy, u, s, v, mask)
    assert dx.shape == (t, q * k) and dx.dtype == B16
    assert _rel(dx.float().numpy(), dxj) < 2 ** -7
    # and the plain version the card holds the kernel against
    assert _rel(dx.float().numpy(),
                ref.feedback_matmul_ref(dy, u, s, v, mask).float().numpy()) \
        < 2 ** -7


@pytest.mark.parametrize("k", TC_K)
def test_a_q_block_masked_everywhere_gives_exact_zeros(k):
    p, q, t = 3, 3, 70
    dy, u, s, v = _operands(t, p, q, k, B16, seed=k + 5)
    mask = _btopk_mask(q, p, k)
    mask[1] = 0.0                        # q block 1 keeps no p block
    dx = ref.feedback_matmul_tc_ref(dy, u, s, v, mask)
    assert int(torch.count_nonzero(dx[:, k:2 * k])) == 0
    assert int(torch.count_nonzero(dx[:, :k])) > 0
    assert int(torch.count_nonzero(
        ref.feedback_matmul_tc_ref(dy, u, s, v, torch.zeros(q, p)))) == 0
