"""Port parity: the LM serving stack — ``repro_torch.models.{layers,
attention,ffn,lm}`` and ``repro_torch.configs`` — against the reference's,
for ``smoke:qwen3-4b`` (qk-norm, GQA), ``smoke:gemma2-27b`` (local/global
window, soft-caps, sandwich norms, GeGLU) and ``smoke:chatglm3-6b`` (half
rotary, qkv bias, untied unembedding), and for the ssm, hybrid and MoE
families (``smoke:falcon-mamba-7b``, ``smoke:jamba-1.5-large-398b``,
``smoke:qwen3-moe-30b-a3b``, ``smoke:moonshot-v1-16b-a3b``): their period
plans, parameter trees (the experts' factors carried as (n_periods, E,
P, Q, k, k)), the hook's layer names over a serve step (no expert among
them), the gateway step at mamba and mixed attention/mamba positions
(logits, new KV rows and replacement ``h`` within 1e-5; the new bf16
conv rows within one bf16 step, 2^-7, where a rounding tie of an fp32
activation goes the other way), and the reference's refusals.

Parameters come from ``repro.models.lm.init_model`` and are carried over
with ``convert.lm_params``; inputs are made with numpy from a seed; the
KV views are bf16 on both sides, as the gateway's pools are.  Errors are
stated relative to the largest entry of the reference output.

* rotary, norms, the MLP and both paged attention functions: 1e-5;
* one ``build_gateway_step`` and one ``build_gateway_prefill_step``:
  logits and new KV rows within 1e-5;
* the PTC layer names an execution hook sees over one step equal the
  reference's (its unrolled, unjitted step);
* bf16 bases (the full-width dtype): logits and new KV rows within 2e-2,
  about two bf16 ulps at the largest entry (the two frameworks round the
  bf16 intermediates — scaled embedding, composed weights, products,
  norms, rotary — at other places).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as jARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import attention as jattn
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import (ARCH_NAMES, get_config, parse_arch,
                                 smoke_config)
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
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


ARCHS = ["qwen3-4b", "gemma2-27b", "chatglm3-6b"]
FAMILIES = ["falcon-mamba-7b", "jamba-1.5-large-398b", "qwen3-moe-30b-a3b",
            "moonshot-v1-16b-a3b"]
B, C, S = 3, 4, 16
LENS = np.asarray([0, 5, 11], np.int32)


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@functools.lru_cache(maxsize=None)
def _model(name: str, bf16: bool = False):
    jcfg, tcfg = jsmoke_config(name), smoke_config(name)
    if bf16:
        jcfg = dataclasses.replace(jcfg, ptc=jlayers.PTCLinearCfg(
            k=8, base_dtype=jnp.bfloat16))
        tcfg = dataclasses.replace(tcfg, ptc=tlayers.PTCLinearCfg(
            k=8, base_dtype=torch.bfloat16))
    jp = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.lm_params(jp)


def _views(jcfg, seed=0):
    plan, n_periods = jlm.period_plan(jcfg)
    rng = np.random.default_rng(seed)
    shape = (n_periods, B, S, jcfg.n_kv_heads, jcfg.hd)
    raw = {f"pos{i}": {kk: rng.normal(size=shape).astype(np.float32)
                       for kk in ("k", "v")} for i in range(len(plan))}
    jv = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), raw)
    tv = jax.tree.map(lambda a: torch.from_numpy(a).to(torch.bfloat16), raw)
    return jv, tv


def _batch(jcfg, chunk: bool, seed=1):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, jcfg.vocab, size=(B, C if chunk else 1))
    tok = tok.astype(np.int32)
    raw = {"token": tok, "lens": LENS}
    if chunk:
        raw["n_valid"] = np.asarray([4, 1, 3], np.int32)
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def test_registry_and_configs_follow_the_reference():
    assert ARCH_NAMES == jARCH_NAMES
    assert sorted(ARCH_NAMES) == sorted(["qwen3-4b", "olmo-1b", "chatglm3-6b",
                                         "gemma2-27b", "whisper-base",
                                         "llama-3.2-vision-11b", *FAMILIES])
    fields = [f.name for f in dataclasses.fields(tlm.ArchConfig)
              if f.name != "ptc"]
    for name in ARCH_NAMES:
        for jc, tc in ((jsmoke_config(name), parse_arch("smoke:" + name)),
                       (jget_config(name), get_config(name))):
            assert {f: getattr(tc, f) for f in fields} == \
                {f: getattr(jc, f) for f in fields}
            assert (tc.ptc.k, tc.ptc.mode) == (jc.ptc.k, jc.ptc.mode)
            assert str(tc.ptc.sigma_dtype).replace("torch.", "") == \
                jnp.dtype(jc.ptc.sigma_dtype).name
            (jplan, jn), (tplan, tn) = jlm.period_plan(jc), \
                tlm.period_plan(tc)
            assert [dataclasses.astuple(q) for q in tplan] == \
                [dataclasses.astuple(q) for q in jplan] and tn == jn
    with pytest.raises(KeyError):
        get_config("gpt-2")


@pytest.mark.parametrize("name", ARCHS)
def test_init_model_tree_matches_reference(name):
    """Same tree, leaf shapes and dtypes (bf16 bases, fp32 Σ and norms),
    per-position leaves stacked on the period axis; Σ Glorot-scaled."""
    for bf16 in (False, True):
        _, tcfg, jp, _ = _model(name, bf16)
        tp = tlm.init_model(torch.Generator().manual_seed(0), tcfg)
        want = {k: (tuple(a.shape), str(a.dtype)) for k, a in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
        got = {k: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
               for k, a in jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert got == want
        s_j = np.asarray(jp["pos0"]["mlp"]["up"]["s"])
        s_t = tp["pos0"]["mlp"]["up"]["s"].numpy()
        assert 0.7 < s_t.std() / s_j.std() < 1.4


def test_unported_families_raise():
    """Every family of the reference has a plan (vlm and encdec since the
    training slice); a family the reference does not know raises."""
    for name in ("llama-3.2-vision-11b", "whisper-base"):
        tlm.init_model(torch.Generator().manual_seed(0), smoke_config(name))
    cfg = dataclasses.replace(smoke_config("qwen3-4b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        tlm.init_model(torch.Generator().manual_seed(0), cfg)


@pytest.mark.parametrize("frac,theta", [(1.0, 1e6), (0.5, 1e4)])
def test_rotary_matches_reference(frac, theta):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, C, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 600, size=(B, C)).astype(np.int32)
    jc, js = jlayers.rotary_cache(jnp.asarray(pos), 16, theta, frac)
    want = jlayers.apply_rotary(jnp.asarray(x), jc, js)
    tc, ts = tlayers.rotary_cache(torch.from_numpy(pos), 16, theta, frac)
    got = tlayers.apply_rotary(torch.from_numpy(x), tc, ts)
    assert _rel(got, want) < 1e-5
    if frac < 1:                          # the trailing half passes through
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_norms_and_softcap_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.normal(size=(B, C, 64)) + 1).astype(np.float32)
    g, bb = (rng.normal(size=(64,)).astype(np.float32) for _ in range(2))
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32)
    tol = 1e-5 if dtype == "fp32" else 8e-3      # one bf16 ulp
    pairs = [
        (jlayers.rmsnorm({"g": jnp.asarray(g)}, jx),
         tlayers.rmsnorm({"g": torch.from_numpy(g)}, tx)),
        (jlayers.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(bb)}, jx),
         tlayers.layernorm({"g": torch.from_numpy(g),
                            "b": torch.from_numpy(bb)}, tx)),
        (jlayers.layernorm_np(jx), tlayers.layernorm_np(tx)),
        (jlayers.softcap(jx, 2.0), tlayers.softcap(tx, 2.0)),
    ]
    for want, got in pairs:
        assert got.dtype == tx.dtype
        assert _rel(got, want) < tol


@pytest.mark.parametrize("name", ARCHS)
def test_mlp_matches_reference(name):
    jcfg, tcfg, jp, tp = _model(name)
    x = np.random.default_rng(2).normal(size=(B, C, 64)).astype(np.float32)
    want = jffn.mlp(jax.tree.map(lambda a: a[1], jp["pos0"]["mlp"]),
                    jcfg.ffn_cfg(), jcfg.ptc, jnp.asarray(x))
    got = tffn.mlp(_period_leaves(tp["pos0"]["mlp"], 1), tcfg.ffn_cfg(),
                   tcfg.ptc, torch.from_numpy(x))
    assert _rel(got, want) < 1e-5


def _period_leaves(tree, i):
    return tlayers.tree_map(lambda a: a[i], tree)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("chunked", [False, True])
def test_paged_attention_matches_reference(name, chunked):
    jcfg, tcfg, jp, tp = _model(name)
    pos = len(jlm.period_plan(jcfg)[0]) - 1        # gemma2: the global one
    plan = jlm.period_plan(jcfg)[0][pos]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, C if chunked else 1, 64)).astype(np.float32)
    kv = [rng.normal(size=(B, S, jcfg.n_kv_heads, jcfg.hd)).astype(
        np.float32) for _ in range(2)]
    jkv = [jnp.asarray(a, jnp.bfloat16) for a in kv]
    tkv = [torch.from_numpy(a).to(torch.bfloat16) for a in kv]
    jparams = jax.tree.map(lambda a: a[0], jp[f"pos{pos}"]["attn"])
    tparams = _period_leaves(tp[f"pos{pos}"]["attn"], 0)
    if chunked:
        want = jattn.decode_attention_paged_chunked(
            jparams, jcfg.attn_cfg(plan.window), jcfg.ptc, jnp.asarray(x),
            *jkv, jnp.asarray(LENS), kv_block=4)
        got = tattn.decode_attention_paged_chunked(
            tparams, tcfg.attn_cfg(plan.window), tcfg.ptc,
            torch.from_numpy(x), *tkv, torch.from_numpy(LENS), kv_block=4)
    else:
        want = jattn.decode_attention_paged(
            jparams, jcfg.attn_cfg(plan.window), jcfg.ptc, jnp.asarray(x),
            *jkv, jnp.asarray(LENS))
        got = tattn.decode_attention_paged(
            tparams, tcfg.attn_cfg(plan.window), tcfg.ptc,
            torch.from_numpy(x), *tkv, torch.from_numpy(LENS))
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


def _steps(jcfg, tcfg, chunk):
    if chunk:
        return (jlm.build_gateway_prefill_step(jcfg, kv_block=8),
                tlm.build_gateway_prefill_step(tcfg, kv_block=8))
    return jlm.build_gateway_step(jcfg), tlm.build_gateway_step(tcfg)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("chunk", [False, True])
def test_gateway_steps_match_reference(name, chunk):
    jcfg, tcfg, jp, tp = _model(name)
    jv, tv = _views(jcfg)
    jb, tb = _batch(jcfg, chunk)
    jstep, tstep = _steps(jcfg, tcfg, chunk)
    want_logits, want_kv = jax.jit(jstep)(jp, jv, jb)
    logits, new_kv = tstep(tp, tv, tb)
    assert tuple(logits.shape) == (B, jcfg.vocab)
    assert _rel(logits, want_logits) < 1e-5
    for name_ in want_kv:
        for kk in ("k", "v"):
            assert _rel(new_kv[name_][kk], want_kv[name_][kk]) < 1e-5


@pytest.mark.parametrize("name", ARCHS)
def test_hook_sees_the_reference_layer_names(name):
    jcfg, tcfg, jp, tp = _model(name)
    jv, tv = _views(jcfg)
    jb, tb = _batch(jcfg, True)
    seen = {"j": [], "t": []}

    def recorder(side):
        def hook(layer, p, x, cfg, d_out):
            seen[side].append(layer)
            return None                       # stay digital
        return hook

    jstep = jlm.build_gateway_prefill_step(
        dataclasses.replace(jcfg, unroll=True), kv_block=8)
    with jlayers.ptc_execution(recorder("j")):
        jstep(jp, jv, jb)
    with tlayers.ptc_execution(recorder("t")):
        tlm.build_gateway_prefill_step(tcfg, kv_block=8)(tp, tv, tb)
    assert seen["t"] == seen["j"]
    assert len(seen["j"]) == 7 * jcfg.n_layers and "p0.s0.attn.wq" in seen["j"]


def test_hook_output_replaces_the_digital_layer():
    _, tcfg, _, tp = _model("qwen3-4b")
    p = _period_leaves(tp["pos0"]["mlp"], 0)
    x = torch.ones((2, 64))
    with tlayers.ptc_execution(lambda *a: torch.full((2, 96), 7.0)):
        with tlayers.ptc_scope("p0.s0.mlp"):
            y = tlayers.apply_ptc_linear(p["gate"], x, tcfg.ptc, d_out=96,
                                         name="gate")
    assert torch.equal(y, torch.full((2, 96), 7.0))


@pytest.mark.parametrize("name", ["qwen3-4b", "gemma2-27b"])
def test_gateway_step_with_bf16_bases_matches_reference(name):
    jcfg, tcfg, jp, tp = _model(name, bf16=True)
    assert tp["pos0"]["mlp"]["up"]["u"].dtype == torch.bfloat16
    assert tp["pos0"]["mlp"]["up"]["s"].dtype == torch.float32
    assert tp["embed"]["e"].dtype == torch.bfloat16
    jv, tv = _views(jcfg)
    jb, tb = _batch(jcfg, True)
    jstep, tstep = _steps(jcfg, tcfg, True)
    want_logits, want_kv = jax.jit(jstep)(jp, jv, jb)
    logits, new_kv = tstep(tp, tv, tb)
    assert logits.dtype == torch.bfloat16
    assert _rel(logits, want_logits) < 2e-2
    for kk in ("k", "v"):
        assert _rel(new_kv["pos0"][kk], want_kv["pos0"][kk]) < 2e-2


def test_lm_params_keeps_each_leaf_dtype():
    jp = {"a": jnp.asarray([1.5, -2.25], jnp.bfloat16),
          "b": {"c": jnp.asarray([[0.1]], jnp.float32)}}
    tp = convert.lm_params(jp)
    assert tp["a"].dtype == torch.bfloat16 and tp["b"]["c"].dtype == \
        torch.float32
    assert tp["a"].tolist() == [1.5, -2.25]


# -- the ssm, hybrid and MoE families ----------------------------------------


def _tree_spec(tree, torch_side):
    return {k: (tuple(a.shape), str(a.dtype).replace("torch.", "")
                if torch_side else str(a.dtype))
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", FAMILIES)
def test_new_family_init_model_tree_matches_reference(name):
    """Same tree, shapes and dtypes as the reference's (mamba, MoE and
    no-FFN positions), for fp32 and bf16 bases; the carried tree keeps
    every leaf, the experts' (n_periods, E, P, Q, k, k) factors included."""
    for bf16 in (False, True):
        jcfg, tcfg, jp, tp = _model(name, bf16)
        mine = tlm.init_model(torch.Generator().manual_seed(0), tcfg)
        assert _tree_spec(mine, True) == _tree_spec(jp, False)
        assert _tree_spec(tp, True) == _tree_spec(jp, False)
    plan, n_periods = tlm.period_plan(tcfg)
    for i, sub in enumerate(plan):
        pos = tp[f"pos{i}"]
        assert ("mamba" in pos) == (sub.kind == "mamba")
        assert ("moe" in pos) == (sub.ffn == "moe")
        assert ("ln2" in pos) == (sub.ffn != "none")
        if sub.ffn == "moe":
            u = pos["moe"]["experts"]["up"]["u"]
            assert tuple(u.shape) == (n_periods, tcfg.n_experts, 12, 8, 8, 8)
            np.testing.assert_array_equal(
                u.float().numpy(), np.asarray(jp[f"pos{i}"]["moe"]["experts"][
                    "up"]["u"], np.float32))


def _serve_views(jcfg, b=B, s=S, seed=0):
    """A decode state for every plan position, random: bf16 K/V at
    attention positions, fp32 ``h`` and bf16 conv rows at mamba ones."""
    plan, n_periods = jlm.period_plan(jcfg)
    rng = np.random.default_rng(seed)
    raw, dtypes = {}, {}
    for i, sub in enumerate(plan):
        if sub.kind == "attn":
            shape = (n_periods, b, s, jcfg.n_kv_heads, jcfg.hd)
            raw[f"pos{i}"] = {kk: rng.normal(size=shape) for kk in "kv"}
            dtypes[f"pos{i}"] = {"k": "bf16", "v": "bf16"}
        else:
            sc = jcfg.ssm_cfg()
            raw[f"pos{i}"] = {
                "h": rng.normal(size=(n_periods, b, sc.d_inner, sc.d_state)),
                "conv": rng.normal(size=(n_periods, b, sc.conv_width - 1,
                                         sc.d_inner))}
            dtypes[f"pos{i}"] = {"h": "fp32", "conv": "bf16"}
    jv = jax.tree.map(lambda a, d: jnp.asarray(
        a, jnp.bfloat16 if d == "bf16" else jnp.float32), raw, dtypes)
    return jv, convert.lm_params(jv)


def _hybrid_dense_ffn():
    """jamba's period (attention, then seven mamba positions) with MLPs
    everywhere: the hybrid the gateway serves."""
    return (dataclasses.replace(jsmoke_config("jamba-1.5-large-398b"),
                                n_experts=0),
            dataclasses.replace(smoke_config("jamba-1.5-large-398b"),
                                n_experts=0))


@pytest.mark.parametrize("which", ["falcon-mamba-7b", "hybrid"])
def test_gateway_step_with_mamba_positions_matches_reference(which):
    if which == "hybrid":
        jcfg, tcfg = _hybrid_dense_ffn()
        plan = tlm.period_plan(tcfg)[0]
        assert [q.kind for q in plan] == ["attn"] + ["mamba"] * 7
        assert {q.ffn for q in plan} == {"mlp"}
    else:
        jcfg, tcfg = jsmoke_config(which), smoke_config(which)
    jp = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params(jp)
    jv, tv = _serve_views(jcfg)
    jb, tb = _batch(jcfg, False)
    want_logits, want_new = jax.jit(jlm.build_gateway_step(jcfg))(jp, jv, jb)
    logits, new = tlm.build_gateway_step(tcfg)(tp, tv, tb)
    assert _rel(logits, want_logits) < 1e-5
    assert set(new) == set(want_new)
    for pos in want_new:
        assert set(new[pos]) == set(want_new[pos])
        for kk in want_new[pos]:
            assert tuple(new[pos][kk].shape) == want_new[pos][kk].shape
            assert str(new[pos][kk].dtype).replace("torch.", "") == \
                str(want_new[pos][kk].dtype)
            if kk == "conv":        # bf16 rows of fp32 activations: a tie
                # may round the other way, one bf16 step (2^-7) at most
                assert _rel(new[pos][kk], want_new[pos][kk]) <= 2 ** -7
            else:
                assert _rel(new[pos][kk], want_new[pos][kk]) < 1e-5


@pytest.mark.parametrize("name", FAMILIES)
def test_hook_sees_the_reference_names_over_a_serve_step(name):
    """One serve step, hook installed: the same layer names in the same
    order as the reference's unrolled, unjitted step, and no expert among
    them (the reference's experts run under vmap, where its hook is
    inert)."""
    jcfg, tcfg, jp, tp = _model(name)
    jv, tv = _serve_views(jcfg)
    batch = np.random.default_rng(1).integers(0, jcfg.vocab, size=(B, 1))
    seen = {"j": [], "t": []}

    def recorder(side):
        def hook(layer, p, x, cfg, d_out):
            seen[side].append(layer)
            return None                       # stay digital
        return hook

    with jlayers.ptc_execution(recorder("j")):
        jlm.build_serve_step(dataclasses.replace(jcfg, unroll=True))(
            jp, jv, {"token": jnp.asarray(batch, jnp.int32),
                     "cache_len": jnp.asarray(5, jnp.int32)})
    with tlayers.ptc_execution(recorder("t")):
        tlm.build_serve_step(tcfg)(tp, tv, {"token": torch.from_numpy(batch),
                                            "cache_len": 5})
    assert seen["t"] == seen["j"] and seen["j"]
    assert not any("moe" in n or "expert" in n for n in seen["t"])
    plan, n_periods = tlm.period_plan(tcfg)
    per_sub = {("attn", "mlp"): 7, ("attn", "moe"): 4, ("mamba", "none"): 4,
               ("mamba", "mlp"): 7, ("mamba", "moe"): 4}
    assert len(seen["t"]) == n_periods * sum(per_sub[(q.kind, q.ffn)]
                                             for q in plan)


def test_gateway_steps_refuse_what_the_reference_refuses():
    for name in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"):
        for build in (tlm.build_gateway_step,
                      tlm.build_gateway_prefill_step):
            with pytest.raises(ValueError, match="does not support MoE"):
                build(smoke_config(name))
    for cfg in (smoke_config("falcon-mamba-7b"), _hybrid_dense_ffn()[1]):
        with pytest.raises(ValueError, match="attention-only"):
            tlm.build_gateway_prefill_step(cfg)
        tlm.build_gateway_step(cfg)           # the one-token path serves it
