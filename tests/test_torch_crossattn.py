"""Port parity: cross-attention on the serving path — the solo serve step
of the vlm (llama-3.2-vision-11b) and encdec (whisper-base) families,
``greedy_decode``'s ``extras`` and ``launch.serve.run``'s stub inputs —
against the reference on the CPU.

Parameters come from the reference's ``init_model`` and are carried over
with ``convert.lm_params``; the image tokens / encoder output are made with
numpy from a seed.  Each serve step starts from the reference's cache of
the step before; both keep K/V in bf16, so a new row at a rounding tie may
round the other way, and such a step is held at 5e-5 (as
``tests/test_torch_serve.py`` holds it).

* the serve step over 8 steps, K and V of the cross-attention recomputed
  from ``img`` / ``enc_out`` at every step: 1e-5 (fp32);
* teacher-forced decode against ``forward``'s logits on the same tokens
  and cross input, the reference's ``test_decode_matches_prefill_logits``
  limit (2e-2), for vlm and encdec (whose forward runs the encoder: the
  serve step is handed its normalized output as ``enc_out``);
* ``greedy_decode`` with ``extras``: the reference's tokens and per-step
  predictions;
* the PTC layer names an execution hook sees over a vlm step: the
  reference's, ``.cross`` included;
* the gateway steps refuse vlm and encdec with the reference's message;
  ``launch.serve.run`` serves both on the CPU with the reference's 0.1
  stub inputs.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_util import model, rel
from repro.launch.steps import greedy_decode as j_greedy_decode
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import serve
from repro_torch.launch.steps import greedy_decode
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from test_torch_serve import TIE_TOL, _bf16_cache_close

TOL = 1e-5
DECODE_TOL = 2e-2
FAMILIES = ["llama-3.2-vision-11b", "whisper-base"]
B, STEPS = 3, 8


def _cross(cfg, seed=0, n=None):
    """The step's cross input as (name, numpy (B, n, d))."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return "img", 0.5 * rng.normal(size=(B, n or cfg.n_img_tokens,
                                              cfg.d_model))
    return "enc_out", 0.5 * rng.normal(size=(B, n or 12, cfg.d_model))


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_step_matches_reference(name):
    jc, tc, jp, tp = model(name)
    key, cross = _cross(jc)
    jx, tx = jnp.asarray(cross, jnp.float32), \
        torch.from_numpy(cross.astype(np.float32))
    toks = lm_batch(2, 0, B, STEPS, jc.vocab)["tokens"]
    jstep = jax.jit(jlm.build_serve_step(jc))
    tstep = tlm.build_serve_step(tc)
    jcache = jlm.init_decode_cache(jc, B, STEPS)
    ties = 0
    for t in range(STEPS):
        tcache = convert.lm_params(jcache)
        jl, jcache = jstep(jp, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.asarray(t, jnp.int32), key: jx})
        tl, tcache = tstep(tp, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "cache_len": t,
            key: tx})
        tie = False
        for pos in jcache:
            for kk in ("k", "v"):
                assert _bf16_cache_close(tcache[pos][kk], jcache[pos][kk])
                tie |= not torch.equal(
                    tcache[pos][kk].float(), torch.as_tensor(np.asarray(
                        jcache[pos][kk]).astype(np.float32)))
        ties += tie
        assert rel(tl, jl) < (TIE_TOL if tie else TOL), (t, rel(tl, jl))
    assert ties <= STEPS // 3


@pytest.mark.parametrize("name", FAMILIES)
def test_teacher_forced_decode_matches_forward(name):
    """The serve path against the training forward (the reference's
    ``test_decode_matches_prefill_logits``): vlm with the same image
    tokens; encdec with the encoder's normalized output of the frames
    handed to the serve step as ``enc_out``."""
    _, tc, _, tp = model(name)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, tc.vocab, (B, STEPS)))
    key, cross = _cross(tc, seed=4)
    cross = torch.from_numpy(cross.astype(np.float32))
    batch = {"tokens": toks}
    if key == "img":
        batch["img"] = cross
        kv = cross
    else:
        batch["frames"] = cross
        pos = torch.arange(cross.shape[1])[None].expand(B, -1)
        with torch.no_grad():
            enc, _ = tlm._run_stack(tc, [tlm.ENC_PLAN], [tp["enc"]],
                                    tc.n_enc_layers, cross, pos)
            kv = tlm._apply_norm(tc, tp["enc_norm"], enc)
    with torch.no_grad():
        logits, _ = tlm.forward(tp, tc, batch)
    step = tlm.build_serve_step(tc)
    cache = tlm.init_decode_cache(tc, B, STEPS, device="cpu")
    for i in range(STEPS):
        out, cache = step(tp, cache, {"token": toks[:, i:i + 1],
                                      "cache_len": i, key: kv})
        assert rel(out, logits[:, i].numpy()) < DECODE_TOL, i


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_decode_with_extras_matches_reference(name):
    jc, tc, jp, tp = model(name)
    key, cross = _cross(jc, seed=5)
    prompt = lm_batch(0, 0, B, 5, jc.vocab)["tokens"]
    jpreds, tpreds = [], []
    jgen, _ = j_greedy_decode(
        jax.jit(jlm.build_serve_step(jc)), jp,
        jlm.init_decode_cache(jc, B, 12), prompt, 7,
        extras={key: jnp.asarray(cross, jnp.float32)}, preds_out=jpreds)
    tgen, _ = greedy_decode(
        tlm.build_serve_step(tc), tp,
        tlm.init_decode_cache(tc, B, 12, device="cpu"), prompt, 7,
        extras={key: torch.from_numpy(cross.astype(np.float32))},
        preds_out=tpreds)
    assert np.array_equal(tgen, jgen)
    assert np.array_equal(np.stack(tpreds, 1), np.stack(jpreds, 1))


def test_hook_sees_the_reference_names_over_a_vlm_step():
    """One unrolled, unjitted reference serve step and the port's give an
    installed hook the same layer names in the same order."""
    jc, tc, jp, tp = model("llama-3.2-vision-11b")
    _, cross = _cross(jc, seed=6)
    names = {"j": [], "t": []}

    def hook(which):
        def record(name, p, x, cfg, d_out):
            names[which].append(name)
            return None
        return record

    ju = dataclasses.replace(jc, unroll=True)
    with jlayers.ptc_execution(hook("j")):
        jlm.build_serve_step(ju)(jp, jlm.init_decode_cache(ju, B, 4), {
            "token": jnp.zeros((B, 1), jnp.int32),
            "cache_len": jnp.asarray(0, jnp.int32),
            "img": jnp.asarray(cross, jnp.float32)})
    with tlayers.ptc_execution(hook("t")):
        tlm.build_serve_step(tc)(tp, tlm.init_decode_cache(
            tc, B, 4, device="cpu"), {
            "token": torch.zeros((B, 1), dtype=torch.int64), "cache_len": 0,
            "img": torch.from_numpy(cross.astype(np.float32))})
    assert names["t"] == names["j"]
    assert any(".cross.wk" in n for n in names["t"])


@pytest.mark.parametrize("name", FAMILIES)
def test_gateway_steps_refuse_vlm_and_encdec(name):
    cfg = smoke_config(name)
    family = cfg.family
    for build in (tlm.build_gateway_step, tlm.build_gateway_prefill_step):
        with pytest.raises(ValueError, match=f"does not support {family} "
                                             f"archs .*not paged yet"):
            build(cfg)
        with pytest.raises(ValueError, match=f"does not support {family}"):
            getattr(jlm, build.__name__)(model(name)[0])


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_run_on_the_cpu(name, capsys):
    """``launch.serve`` makes the reference's stub cross inputs (0.1 ones:
    ``img`` of n_img tokens, ``enc_out`` of prompt_len frames)."""
    out = serve.run(argparse.Namespace(
        arch="smoke:" + name, batch=2, prompt_len=4, gen=3, seed=0,
        device="cpu", trace_logits=True))
    assert out["gen"].shape == (2, 3) and np.isfinite(out["logits"]).all()
    assert serve.main(["--arch", "smoke:" + name, "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen",
                       "3"]) == 0
    assert "generated (2, 3) tokens" in capsys.readouterr().out
