"""Port parity: ``repro_torch.kernels.prefill_attention`` (its plain version
on the CPU) against the reference's Pallas prefill kernel in interpret
mode (``repro.kernels.ops.prefill_attention``).

* the reference test's 12 (blk, window, cap) cases at atol 2e-5, fp32;
* fp32 queries over bf16 K/V views (the smoke LM's types) at 2e-5;
* a block the window never sees changes no bit of the output;
* a block that does not divide the view raises the reference's
  ``ValueError``; the kernel's key tile never straddles a block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import prefill_attention
from repro_torch.kernels.prefill_attn import _tile


def _inputs(seed, b, c, h, hkv, hd, s):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, c, h, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32),
            rng.normal(size=(b, s, hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("blk", [None, 8, 4])
@pytest.mark.parametrize("window,cap", [(None, None), (6, None),
                                        (None, 3.0), (5, 2.0)])
def test_prefill_matches_reference_kernel(blk, window, cap):
    q, k, v = _inputs(0, 3, 5, 4, 2, 8, 24)
    lens = np.asarray([0, 7, 19], np.int32)
    kw = dict(blk=blk, window=window, cap=cap)
    want = ops.prefill_attention(jnp.asarray(lens), jnp.asarray(q),
                                 jnp.asarray(k), jnp.asarray(v), **kw)
    got = prefill_attention(torch.from_numpy(lens), torch.from_numpy(q),
                            torch.from_numpy(k), torch.from_numpy(v), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_prefill_fp32_queries_over_bf16_views_match_reference(window):
    q, k, v = _inputs(1, 2, 4, 4, 2, 16, 32)
    lens = np.asarray([3, 26], np.int32)
    want = ops.prefill_attention(
        jnp.asarray(lens), jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), blk=8, window=window, cap=50.0)
    got = prefill_attention(
        torch.from_numpy(lens), torch.from_numpy(q),
        torch.from_numpy(k).to(torch.bfloat16),
        torch.from_numpy(v).to(torch.bfloat16), blk=8, window=window,
        cap=50.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_prefill_fully_masked_block_is_exact_zero():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 2, 2, 1, 4, 16))
    lens = torch.tensor([12], dtype=torch.int32)
    base = prefill_attention(lens, q, k, v, blk=4, window=3)
    k2, v2 = k.clone(), v.clone()
    k2[:, :8], v2[:, :8] = 999.0, -999.0    # keys the window never sees
    poked = prefill_attention(lens, q, k2, v2, blk=4, window=3)
    assert torch.equal(base, poked)


def test_prefill_rejects_indivisible_block():
    with pytest.raises(ValueError, match="not divisible"):
        prefill_attention(torch.zeros((1,), dtype=torch.int32),
                          torch.zeros((1, 2, 2, 4)), torch.zeros((1, 10, 1, 4)),
                          torch.zeros((1, 10, 1, 4)), blk=4)


@pytest.mark.parametrize("blk", [1, 4, 8, 24, 32, 40, 64, 640])
def test_kernel_tile_divides_the_block(blk):
    t = _tile(blk)
    assert 1 <= t <= 32 and blk % t == 0
    assert t == min(blk, 32) or blk % 32 != 0
