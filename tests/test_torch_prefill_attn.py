"""Port parity: ``repro_torch.kernels.prefill_attention`` (its plain version
on the CPU) against the reference's Pallas prefill kernel in interpret
mode (``repro.kernels.ops.prefill_attention``).

* the reference test's 12 (blk, window, cap) cases at atol 2e-5, fp32;
* fp32 queries over bf16 K/V views (the smoke LM's types) at 2e-5;
* a block the window never sees changes no bit of the output;
* a block that does not divide the view raises the reference's
  ``ValueError``; neither kernel reads ``blk`` (their key tiles are their
  own), so the C call takes no argument from it and ``blk`` changes no bit;
* the wrapper's route between its two CUDA kernels is a rule on the dtypes
  and the head dim alone (bf16/bf16 at Dh 64 and 128 on the tensor cores),
  each route with its own launch counter and library.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import build, prefill_attention
from repro_torch.kernels.prefill_attn import route
from repro_torch.kernels.ref import prefill_attention_ref


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


def _c_params(src, name):
    """Parameter names of ``extern "C" int <name>(...)`` in a csrc file."""
    text = (build.CSRC / src).read_text()
    sig = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
    return [p.split()[-1].lstrip("*") for p in sig.group(1).split(",")]


@pytest.mark.parametrize("blk", [1, 4, 8, 24, 32, 40, 64, 640])
def test_kernel_tile_divides_the_block(blk, monkeypatch):
    """The CUDA-core kernel's key tile is its own (64 keys, 32 past head dim
    128), so it need not divide ``blk``: nothing the C call receives depends
    on ``blk``, and ``blk`` changes no bit of the result."""
    from types import SimpleNamespace

    from repro_torch.kernels import prefill_attn
    params = _c_params(build.SOURCES[prefill_attn.LIB], "prefill_attention")
    assert not any("blk" in p.lower() or "tile" in p.lower() for p in params)
    # the wrapper binds exactly the C entry point's parameters
    fake = SimpleNamespace(prefill_attention=SimpleNamespace(argtypes=None))
    monkeypatch.setattr(build, "library", lambda lib: fake)
    assert len(prefill_attn._fn().argtypes) == len(params)
    # a view every case divides: lcm(24, 40, 64, 640) = 1920
    q, k, v = (torch.from_numpy(a) for a in _inputs(blk, 1, 4, 2, 1, 8, 1920))
    lens = torch.tensor([1900], dtype=torch.int32)
    whole = prefill_attention(lens, q, k, v, window=700)
    assert torch.equal(prefill_attention(lens, q, k, v, blk=blk, window=700),
                       whole)


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,want", [
    (torch.bfloat16, torch.bfloat16, 128, "tensor_cores"),   # the gateway
    (torch.bfloat16, torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, torch.bfloat16, 96, "cuda_cores"),      # no wgmma tile
    (torch.bfloat16, torch.bfloat16, 256, "cuda_cores"),
    (torch.bfloat16, torch.bfloat16, 8, "cuda_cores"),
    (torch.float32, torch.float32, 128, "cuda_cores"),       # TF32 misses 2e-5
    (torch.float32, torch.bfloat16, 128, "cuda_cores"),      # the smoke LM
    (torch.float32, torch.bfloat16, 64, "cuda_cores"),
])
def test_route_is_a_rule_on_dtype_and_head_dim(q_dtype, kv_dtype, hd, want):
    assert route(q_dtype, kv_dtype, hd) == want


def test_each_route_has_its_own_launch_counter_and_library():
    from repro_torch.kernels import build
    from repro_torch.kernels.prefill_attn import LIB, LIB_TC, NAME, \
        NAME_CUDA_CORES
    assert NAME != NAME_CUDA_CORES
    assert build.KERNELS[NAME] == LIB_TC and build.KERNELS[NAME_CUDA_CORES] == LIB
    for lib in (LIB, LIB_TC):
        assert (build.CSRC / build.SOURCES[lib]).is_file()
    assert build.launch_counts[NAME] == build.launch_counts[NAME_CUDA_CORES] \
        == 0   # the CPU path launches neither


def test_bf16_inputs_at_a_tensor_core_head_dim_run_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(2, 2, 3, 4, 2, 64, 16))
    lens = torch.tensor([0, 10], dtype=torch.int32)
    got = prefill_attention(lens, q, k, v, blk=8, window=5)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, prefill_attention_ref(lens, q, k, v, window=5))
