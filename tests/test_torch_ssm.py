"""Port parity: ``repro_torch.models.ssm`` (Mamba-1) against
``repro.models.ssm`` on the CPU.

Parameters come from the reference's ``init_mamba`` and are carried over
with ``convert.lm_params``; inputs are made with numpy from a seed.
Errors are relative to the largest entry of the reference output.

* ``_causal_depthwise_conv``, with and without a carried state, fp32 and
  bf16 inputs (bf16 times the fp32 taps is fp32 on both sides): 1e-5.
* ``mamba_decode`` over 8 steps, each from the reference's state of the
  step before: output and ``h`` within 1e-5, the new bf16 conv state
  equal but for a rounding tie (one bf16 step, at most one entry in a
  thousand), as the serve tests hold the bf16 KV rows.
* ``mamba`` (the chunked scan) at S = 16 with chunk 4 and 16: 1e-5.
* in the port alone, ``mamba`` against S steps of ``mamba_decode`` from
  a state whose conv rows are fp32 (so the decode rounds nothing the
  scan keeps): output, last ``h`` and conv rows within 1e-5.
* bf16 bases: ``mamba_decode`` and ``mamba`` within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm

TOL = 1e-5
BF16_TOL = 2e-2
CFG = dict(d_model=32, d_state=8)       # d_inner 64, rank 2
B, S = 3, 16


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _layer(bf16=False, chunk=256, seed=0):
    jlin = jlayers.PTCLinearCfg(
        k=8, base_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tlin = tlayers.PTCLinearCfg(
        k=8, base_dtype=torch.bfloat16 if bf16 else torch.float32)
    jcfg = jssm.SSMCfg(**CFG, chunk=chunk)
    tcfg = tssm.SSMCfg(**CFG, chunk=chunk)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg, jlin)
    return jcfg, tcfg, jlin, tlin, jp, convert.lm_params(jp)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_ssm_cfg_sizes_follow_the_reference():
    for kw in (CFG, dict(d_model=4096, d_state=16)):
        j, t = jssm.SSMCfg(**kw), tssm.SSMCfg(**kw)
        assert (t.d_inner, t.rank) == (j.d_inner, j.rank)
    assert tssm.SSMCfg(d_model=4096).rank == 256       # falcon-mamba-7b


@pytest.mark.parametrize("bf16", [False, True])
def test_init_mamba_tree_matches_reference(bf16):
    _, tcfg, _, tlin, jp, _ = _layer(bf16)
    tp = tssm.init_mamba(torch.Generator().manual_seed(0), tcfg, tlin)
    want = {k: (tuple(a.shape), str(a.dtype)) for k, a in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for k, a in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert got == want
    for leaf in ("d", "conv_b"):
        np.testing.assert_array_equal(tp[leaf].numpy(), np.asarray(jp[leaf]))
    # log(1..N), within an ulp of jnp.log's
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=1e-6)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("bf16_x", [False, True])
def test_causal_depthwise_conv_matches_reference(carry, bf16_x):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 5, 64)).astype(np.float32)
    w = 0.1 * rng.normal(size=(4, 64)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    st = rng.normal(size=(B, 3, 64)).astype(np.float32) if carry else None
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16_x
                else (jnp.float32, torch.float32))
    jy, jtail = jssm._causal_depthwise_conv(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b),
        None if st is None else jnp.asarray(st, jnp.bfloat16))
    ty, ttail = tssm._causal_depthwise_conv(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b),
        None if st is None else torch.from_numpy(st).to(torch.bfloat16))
    assert ty.dtype == torch.float32 and str(jy.dtype) == "float32"
    assert ttail.dtype == tdt
    assert _rel(ty, jy) < TOL
    np.testing.assert_array_equal(ttail.float().numpy(),
                                  np.asarray(jtail, np.float32))


def _bf16_close(got: torch.Tensor, want) -> bool:
    """Equal, but for at most one entry in a thousand, each within one
    bf16 step of the reference's (a rounding tie taken the other way)."""
    want = torch.as_tensor(np.asarray(want).astype(np.float32))
    got = got.float()
    off = got != want
    return bool((got - want).abs()[off].le(
        2.0 ** -7 * want.abs()[off] + 1e-30).all()) \
        and int(off.sum()) <= max(1, want.numel() // 1000)


@pytest.mark.parametrize("bf16", [False, True])
def test_mamba_decode_matches_reference(bf16):
    jcfg, tcfg, jlin, tlin, jp, tp = _layer(bf16)
    tol = BF16_TOL if bf16 else TOL
    jstep = jax.jit(jssm.mamba_decode, static_argnums=(1, 2))
    jst = jssm.init_ssm_state(B, jcfg)
    tst = tssm.init_ssm_state(B, tcfg)
    assert tst["h"].dtype == torch.float32
    assert tst["conv"].dtype == torch.bfloat16           # for every dtype
    for t in range(8):
        x = _x((B, 1, CFG["d_model"]), seed=10 + t)
        tst = convert.lm_params(jst)
        jy, jst = jstep(jp, jcfg, jlin,
                        jnp.asarray(x, jlin.base_dtype), jst)
        ty, tst = tssm.mamba_decode(tp, tcfg, tlin,
                                    torch.from_numpy(x).to(tlin.base_dtype),
                                    tst)
        assert ty.dtype == tlin.base_dtype
        assert _rel(ty, jy) < tol, (t, _rel(ty, jy))
        assert _rel(tst["h"], jst["h"]) < tol, t
        assert tst["conv"].dtype == torch.bfloat16
        if bf16:
            assert _rel(tst["conv"], jst["conv"]) < tol, t
        else:
            assert _bf16_close(tst["conv"], jst["conv"]), t


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_scan_matches_reference(chunk):
    jcfg, tcfg, jlin, tlin, jp, tp = _layer(chunk=chunk)
    x = _x((B, S, CFG["d_model"]))
    want = jax.jit(jssm.mamba, static_argnums=(1, 2))(jp, jcfg, jlin,
                                                      jnp.asarray(x))
    got = tssm.mamba(tp, tcfg, tlin, torch.from_numpy(x))
    assert _rel(got, want) < TOL


def test_chunked_scan_with_bf16_bases_matches_reference():
    jcfg, tcfg, jlin, tlin, jp, tp = _layer(bf16=True, chunk=4)
    x = _x((B, S, CFG["d_model"]))
    want = jssm.mamba(jp, jcfg, jlin, jnp.asarray(x, jnp.bfloat16))
    got = tssm.mamba(tp, tcfg, tlin, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < BF16_TOL


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_scan_equals_the_decode_recurrence(chunk):
    """``mamba`` over S tokens (chunks of 4, a ragged 5, or one chunk)
    against S single steps of ``mamba_decode``; the decode's conv rows are
    kept in fp32 so neither side rounds what the other keeps."""
    _, tcfg, _, tlin, _, tp = _layer(chunk=chunk)
    x = torch.from_numpy(_x((B, S, CFG["d_model"])))
    y, st = tssm.mamba(tp, tcfg, tlin, x, return_state=True)
    state = tssm.init_ssm_state(B, tcfg)
    state["conv"] = state["conv"].float()
    ys = []
    for t in range(S):
        yt, state = tssm.mamba_decode(tp, tcfg, tlin, x[:, t: t + 1], state)
        ys.append(yt)
    assert _rel(torch.cat(ys, 1), y) < TOL
    assert _rel(state["h"], st["h"]) < TOL
    assert st["conv"].dtype == torch.bfloat16
    assert torch.equal(state["conv"].to(torch.bfloat16), st["conv"])
