"""Port parity: the LM training path's parts — ``repro_torch.models.
attention``'s training attention, the chunked and recomputed forward,
``lm.cross_entropy`` and the rest of ``models/layers.py``
(``mode="dense"``, ``sigma_dtype``, ``partition`` / ``combine``, the
leaves ``convert.lm_params`` carries) — against the reference on the CPU.

Parameters come from the reference's ``init_model`` (or ``init_attention``)
and are carried over with ``convert.lm_params``; inputs are made with numpy
from a seed.  The suite runs JAX in x64, so both sides are given float32
(or bf16) explicitly.  Errors are relative to the largest entry of the
reference output.

* ``_sdpa`` and ``_sdpa_chunked`` (chunk 4) against the reference's, and
  the port's chunked against its full at the reference's own 1e-3
  (``tests/test_arch_smoke.py``); cross-attention (``kv_x`` of another
  length, no rotary): 1e-5 in fp32.
* ``forward`` with ``attn_chunk`` 4 against no chunking (1e-3) and
  against the reference's chunked forward (1e-5); a period recomputed
  under ``torch.utils.checkpoint`` (remat) changes no bit of the loss or
  the gradients; the three remat policies ("full", "dots", "none") are
  accepted and an unknown one raises ("dots" itself is held in
  ``tests/test_torch_remat.py``).
* ``cross_entropy``'s value and its gradient against ``jax.vjp`` of the
  reference's ``_ce``: 1e-5 in fp32; in bf16 the value within 1e-5 and
  the gradient within one bf16 step (2^-8 of the largest entry: the two
  sides' softmax may round one entry differently).
* ``mode="dense"``, ``sigma_dtype`` and ``partition`` / ``combine``:
  trees and outputs as the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_util import (B, S, both as _both, cfgs as _cfgs, leaves,
                            lm_inputs, model as _params, rel as _rel,
                            split_batch)
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5

# -- attention ---------------------------------------------------------------

ATTN = {
    "causal": dict(),
    "gqa_window_cap": dict(n_kv_heads=2, window=5, attn_softcap=20.0),
    "encoder": dict(causal=False),
    "encoder_window": dict(causal=False, window=6),
}


def _attn_cfgs(**kw):
    base = dict(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8)
    base.update(kw)
    return jattn.AttnCfg(**base), tattn.AttnCfg(**base)


def _qkv(seed, sk=S, hkv=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, 4, 8)), rng.normal(size=(B, sk, hkv, 8)),
            rng.normal(size=(B, sk, hkv, 8)))


@pytest.mark.parametrize("which", sorted(ATTN))
def test_sdpa_and_chunked_match_reference(which):
    jc, tc = _attn_cfgs(**ATTN[which])
    q, k, v = (_both(a) for a in _qkv(3, hkv=jc.n_kv_heads))
    want = jattn._sdpa(q[0], k[0], v[0], jc)
    full = tattn._sdpa(q[1], k[1], v[1], tc)
    assert _rel(full, want) < TOL
    jch = jattn._sdpa_chunked(q[0], k[0], v[0], jc, 4)
    tch = tattn._sdpa_chunked(q[1], k[1], v[1], tc, 4)
    assert _rel(tch, jch) < TOL
    assert _rel(tch, np.asarray(full)) < 1e-3


def test_sdpa_chunked_gradients_match_full():
    """The chunked path's recomputed chunks give the full path's
    gradients (autograd through both)."""
    _, tc = _attn_cfgs(**ATTN["gqa_window_cap"])
    q, k, v = (torch.from_numpy(a.astype(np.float32)).requires_grad_()
               for a in _qkv(4, hkv=2))
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=(B, S, 4, 8)).astype(np.float32))
    g_full = torch.autograd.grad(tattn._sdpa(q, k, v, tc), (q, k, v), dy)
    g_ch = torch.autograd.grad(tattn._sdpa_chunked(q, k, v, tc, 4),
                               (q, k, v), dy)
    for a, b in zip(g_ch, g_full):
        assert _rel(a, b.numpy()) < 1e-5


@pytest.mark.parametrize("chunk", [None, 4])
def test_attention_layer_matches_reference(chunk):
    """The whole layer (projections, qk-norm, rotary, attention, output
    projection) at qwen3-style qk-norm with GQA, chunked or not."""
    jc, tc = _attn_cfgs(n_kv_heads=2, qk_norm=True)
    jlin = jlayers.PTCLinearCfg(k=8, base_dtype=jnp.float32)
    tlin = tlayers.PTCLinearCfg(k=8, base_dtype=torch.float32)
    jp = jattn.init_attention(jax.random.PRNGKey(2), jc, jlin)
    tp = convert.lm_params(jp)
    x = _both(np.random.default_rng(6).normal(size=(B, S, 32)))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jattn.attention(jp, jc, jlin, x[0], jnp.asarray(pos), chunk=chunk)
    got = tattn.attention(tp, tc, tlin, x[1], torch.from_numpy(pos),
                          chunk=chunk)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("n_kv", [6, 24])
def test_cross_attention_matches_reference(n_kv):
    """K and V from ``kv_x`` of another length than x; no rotary (the
    reference passes positions None), not causal."""
    jc, tc = _attn_cfgs(n_kv_heads=2, causal=False)
    jlin = jlayers.PTCLinearCfg(k=8, base_dtype=jnp.float32)
    tlin = tlayers.PTCLinearCfg(k=8, base_dtype=torch.float32)
    jp = jattn.init_attention(jax.random.PRNGKey(4), jc, jlin)
    tp = convert.lm_params(jp)
    rng = np.random.default_rng(7)
    x = _both(rng.normal(size=(B, S, 32)))
    kv = _both(rng.normal(size=(B, n_kv, 32)))
    want = jattn.attention(jp, jc, jlin, x[0], None, kv_x=kv[0])
    got = tattn.attention(tp, tc, tlin, x[1], None, kv_x=kv[1])
    assert _rel(got, want) < TOL


def test_mask_bias_matches_reference():
    for causal, window, off in ((True, None, 0), (True, 3, 2),
                                (False, 4, 0), (False, None, 5)):
        want = jattn._mask_bias(5, 9, causal, window, off)
        got = tattn._mask_bias(5, 9, causal, window, off)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_forward_chunked_matches_full():
    """The reference's ``test_chunked_attention_matches_full`` on the port:
    attn_chunk 4 against no chunking, 1e-3; and each against the
    reference's chunked forward, 1e-5."""
    jc, tc, jp, tp = _params("olmo-1b")
    jb, tb = split_batch(lm_inputs(jc, seed=4))
    jcc = dataclasses.replace(jc, attn_chunk=4)
    tcc = dataclasses.replace(tc, attn_chunk=4)
    with torch.no_grad():
        full, _ = tlm.forward(tp, tc, tb)
        chunked, _ = tlm.forward(tp, tcc, tb)
    assert _rel(chunked, full.numpy()) < 1e-3
    assert _rel(chunked, jlm.forward(jp, jcc, jb)[0]) < TOL


def test_remat_changes_no_value():
    """A period under ``torch.utils.checkpoint`` gives the same loss and
    gradients as without it."""
    _, tc, _, tp = _params("gemma2-27b")
    _, tb = split_batch(lm_inputs(tc, seed=5))
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        loss, grads = tlm.build_train_step(cfg)(tp, tb)
        out.append((loss, grads))
    assert float(out[0][0]) == float(out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(out[0][1]),
                                                 leaves(out[1][1])))


def test_unported_remat_policy_raises():
    """The reference's three policies are accepted ("dots" keeps the 2-D
    products' outputs); a policy neither package has raises instead of
    quietly recomputing all."""
    _, tc, _, _ = _params("olmo-1b")
    for policy in ("full", "dots", "none"):
        assert dataclasses.replace(tc, remat_policy=policy).remat_policy \
            == policy
    with pytest.raises(ValueError, match="unknown remat_policy 'attn'"):
        dataclasses.replace(tc, remat_policy="attn")


# -- cross-entropy -----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_entropy_matches_reference(dtype):
    rng = np.random.default_rng(8)
    logits = 3.0 * rng.normal(size=(B, S, 50))
    labels = rng.integers(0, 50, (B, S)).astype(np.int32)
    jl, tl = _both(logits, "bf16" if dtype == "bf16" else np.float32)
    tl.requires_grad_()
    want, vjp = jax.vjp(lambda z: jlm._ce(z, jnp.asarray(labels)), jl)
    (jg,) = vjp(jnp.asarray(1.0, jnp.float32))
    got = tlm.cross_entropy(tl, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(got, tl)
    assert got.dtype == torch.float32
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    assert tg.dtype == tl.dtype
    assert _rel(tg, jg) < (TOL if dtype == "fp32" else 2.0 ** -8)


def test_cross_entropy_gradient_scale():
    """An upstream gradient other than 1 scales the gradient (the
    reference's ``g / n``)."""
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.normal(size=(3, 7)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 7, 3))
    logits.requires_grad_()
    (g1,) = torch.autograd.grad(tlm.cross_entropy(logits, labels), logits)
    (g3,) = torch.autograd.grad(2.5 * tlm.cross_entropy(logits, labels),
                                logits)
    assert torch.allclose(g3, 2.5 * g1, rtol=1e-6, atol=0)
    want = torch.softmax(logits.detach(), -1)
    want[torch.arange(3), labels] -= 1
    assert torch.allclose(g1, want / 3, atol=1e-7)


# -- layers: dense mode, sigma_dtype, partition / combine --------------------


def test_dense_mode_matches_reference():
    """``mode="dense"``: one Glorot ``w`` (d_out, d_in), x @ wᵀ cropped to
    d_out, trainable; never offered to the execution hook."""
    jlin = jlayers.PTCLinearCfg(mode="dense", base_dtype=jnp.float32)
    tlin = tlayers.PTCLinearCfg(mode="dense", base_dtype=torch.float32)
    jp = jlayers.init_ptc_linear(jax.random.PRNGKey(0), 24, 40, jlin,
                                 bias=True)
    tp = tlayers.init_ptc_linear(torch.Generator().manual_seed(0), 24, 40,
                                 tlin, bias=True)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert 0.7 < float(tp["w"].std()) / float(jnp.std(jp["w"])) < 1.4
    cp = convert.lm_params(jp)
    x = _both(np.random.default_rng(1).normal(size=(5, 24)))
    want = jlayers.apply_ptc_linear(jp, x[0], jlin)
    assert _rel(tlayers.apply_ptc_linear(cp, x[1], tlin), want) < TOL
    # cropped to d_out (the reference adds no bias to a cropped output)
    nob = {"w": jp["w"]}
    want = jlayers.apply_ptc_linear(nob, x[0], jlin, d_out=33)
    got = tlayers.apply_ptc_linear({"w": cp["w"]}, x[1], tlin, d_out=33)
    assert _rel(got, want) < TOL
    assert tlayers.trainable_mask(cp) == {"w": True, "b": True}
    seen = []
    with tlayers.ptc_execution(lambda *a: seen.append(a)):
        tlayers.apply_ptc_linear(cp, x[1], tlin, name="w1")
    assert not seen


def test_dense_mode_model_trains_w():
    """A dense-mode smoke model: every linear a trainable ``w``, the train
    step's loss and gradients as the reference's."""
    jc, tc = _cfgs("olmo-1b", mode="dense")
    jp = jlm.init_model(jax.random.PRNGKey(1), jc)
    tp = convert.lm_params(jp)
    jb, tb = split_batch(lm_inputs(jc, seed=6))
    jloss, jg = jlm.build_train_step(jc)(jp, jb, jax.random.PRNGKey(0))
    tloss, tg = tlm.build_train_step(tc)(tp, tb)
    assert abs(float(tloss) - float(jloss)) <= TOL * float(jloss)
    w = tg["pos0"]["mlp"]["up"]["w"]
    assert w.shape == tp["pos0"]["mlp"]["up"]["w"].shape
    assert _rel(w, jg["pos0"]["mlp"]["up"]["w"]) < TOL


def test_sigma_dtype_casts_sigma_before_the_product():
    """Σ is stored in ``sigma_dtype`` and cast to the bases' dtype before
    the product; its gradient returns in its own dtype."""
    cfg = tlayers.PTCLinearCfg(k=8, base_dtype=torch.bfloat16,
                               sigma_dtype=torch.bfloat16, mode="blocked")
    p = tlayers.init_ptc_linear(torch.Generator().manual_seed(0), 16, 16,
                                cfg)
    assert p["s"].dtype == torch.bfloat16 and p["u"].dtype == torch.bfloat16
    jcfg = jlayers.PTCLinearCfg(k=8, base_dtype=jnp.bfloat16,
                                sigma_dtype=jnp.bfloat16, mode="blocked")
    jp = jlayers.init_ptc_linear(jax.random.PRNGKey(0), 16, 16, jcfg)
    assert str(jp["s"].dtype) == "bfloat16"
    # fp32 Σ over bf16 bases: the product sees Σ rounded to bf16
    cfg32 = dataclasses.replace(cfg, sigma_dtype=torch.float32)
    p32 = tlayers.init_ptc_linear(torch.Generator().manual_seed(0), 16, 16,
                                  cfg32)
    assert p32["s"].dtype == torch.float32
    x = torch.randn((4, 16), generator=torch.Generator().manual_seed(1))
    s = p32["s"].clone().requires_grad_()
    y = tlayers.apply_ptc_linear(dict(p32, s=s), x, cfg32)
    y_rounded = tlayers.apply_ptc_linear(
        dict(p32, s=s.detach().to(torch.bfloat16)), x, cfg)
    assert torch.equal(y, y_rounded)
    (g,) = torch.autograd.grad(y.float().sum(), s)
    assert g.dtype == torch.float32


def test_partition_and_combine_match_reference():
    jc, tc, jp, tp = _params("chatglm3-6b")
    jm = jlayers.trainable_mask(jp)
    tm = tlayers.trainable_mask(tp)
    assert jax.tree.leaves(jm) == [m for m in leaves(tm)]
    jsel, jrest = jlayers.partition(jp, jm)
    tsel, trest = tlayers.partition(tp, tm)
    for jt, tt in ((jsel, tsel), (jrest, trest)):
        want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jt)]
        got = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
               for a in leaves(tt)]
        assert got == want
    back = tlayers.combine(tsel, trest, tm)
    assert all(a is b for a, b in zip(leaves(back), leaves(tp)))
    assert tsel["pos0"]["attn"]["wq"]["u"].shape == ()
    assert trest["pos0"]["attn"]["wq"]["s"].shape == ()


def test_lm_params_carries_the_training_leaves():
    """``convert.lm_params`` carries every leaf the training slice adds —
    the encoder stack and its norm, cross-attention and its norm, dense
    ``w`` in bf16, the injected ``fb`` / ``col`` masks — equal, in its own
    dtype."""
    from repro.core.sparsity import SparsityConfig as JSparsity
    jc, _, jp, _ = _params("whisper-base", bf16=True)
    jm = jlm.inject_masks(jp, jax.random.PRNGKey(0),
                          JSparsity(alpha_w=0.6, alpha_c=0.6), B * S)
    dense = jlayers.init_ptc_linear(jax.random.PRNGKey(1), 16, 8,
                                    jlayers.PTCLinearCfg(mode="dense"))
    tree = {"model": jm, "dense": dense}
    got = convert.lm_params(tree)
    for key in ("enc", "enc_norm"):
        assert key in got["model"]
    assert {"cross", "lnx"} <= set(got["model"]["pos0"])
    assert {"fb", "col"} <= set(got["model"]["pos0"]["cross"]["wk"])
    for path, want in jax.tree_util.tree_flatten_with_path(tree)[0]:
        t = got
        for e in path:
            t = t[e.key]
        assert str(t.dtype).replace("torch.", "") == str(want.dtype), path
        assert np.array_equal(t.float().numpy(),
                              np.asarray(want, np.float32)), path
