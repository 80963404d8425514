"""Port parity: the solo serve path (``repro_torch.launch.serve``,
``greedy_decode``, the dense decode cache) against the reference on the
CPU, with the reference's parameters carried over (``convert.lm_params``).

* ``lm_batch``: bitwise (both are numpy).
* ``decode_attention`` (one layer) and ``build_serve_step`` (the whole
  model) over 12 steps at ``smoke:qwen3-4b`` and ``smoke:gemma2-27b``
  (sliding window 8 and soft-caps; 12 steps pass the window), and
  ``build_serve_step`` at the ssm, hybrid and MoE smoke configs
  (``smoke:falcon-mamba-7b``, ``smoke:jamba-1.5-large-398b``,
  ``smoke:qwen3-moe-30b-a3b``, ``smoke:moonshot-v1-16b-a3b``), each step
  from the reference's cache of the step before: outputs and the fp32 SSM
  state ``h`` within 1e-5 of the largest reference entry.  Both keep K/V in bf16, so a new row whose
  fp32 value lies within rounding of a bf16 tie may round the other way:
  the new cache rows are equal but for such entries, each within one bf16
  step (2^-7 relative) and at most one in a thousand.  The step's token
  attends to its own new row, so a step whose rows hold such a flip is
  held at 5e-5 instead (gemma2: one flip of -0.6836 to -0.6875 moves the
  logits by 1.3e-5); at most a third of the steps may have one.  The
  new bf16 conv rows of the SSM state round fp32 activations that agree
  within 1e-5 of the largest entry, so each entry is held within that
  plus one bf16 step of itself (at jamba's small entries a tie can move
  an entry by a third of itself, and then by 1e-6 of the largest); a
  step reads only the conv rows of the steps before it, so a tie there
  does not loosen the step's limit.
* with bf16 bases, ``smoke:falcon-mamba-7b``'s serve step within 2e-2.
* ``greedy_decode``: the reference's tokens and per-step predictions
  (the dense archs above and the four new ones), and its ``eos_id``
  early termination.
* The port's solo tokens equal the port's gateway tokens for the same
  requests (the check of ``tests/test_serving_gateway.py``), for
  ``smoke:qwen3-4b`` and, at chunk 1, ``smoke:falcon-mamba-7b``.
* ``greedy_decode`` runs a layer-execution plane's protocol; ``serve.main``
  serves through the fleet (``--fleet``, ``--hw-logits``) and refuses what
  the reference refuses (the hw flags without a fleet or together, MoE
  archs) and the stream transports.
"""

import argparse
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.data import lm_batch as j_lm_batch
from repro.launch.steps import greedy_decode as j_greedy_decode
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import serve
from repro_torch.launch.steps import greedy_decode
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import (GatewayConfig, PageConfig, ServingGateway,
                                 poisson_workload)

TOL = 1e-5
TIE_TOL = 5e-5      # a step whose new bf16 K/V rows hold a rounding tie
NAMES = ("qwen3-4b", "gemma2-27b")
FAMILIES = ("falcon-mamba-7b", "jamba-1.5-large-398b", "qwen3-moe-30b-a3b",
            "moonshot-v1-16b-a3b")


@functools.lru_cache(maxsize=None)
def _params(name):
    return jlm.init_model(jax.random.PRNGKey(1), jsmoke_config(name))


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-12))


@pytest.mark.parametrize("seed,step,batch,seq,vocab",
                         [(0, 0, 4, 16, 256), (3, 7, 2, 64, 151_936),
                          (5, 1, 1, 1, 50)])
def test_lm_batch_bitwise(seed, step, batch, seq, vocab):
    want = j_lm_batch(seed, step, batch, seq, vocab)
    got = lm_batch(seed, step, batch, seq, vocab)
    for key in ("tokens", "labels"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])


def _bf16_cache_close(got: torch.Tensor, want) -> bool:
    """Equal, but for at most one entry in a thousand, each within one
    bf16 step of the reference's (a tie rounded the other way)."""
    want = torch.as_tensor(np.asarray(want).astype(np.float32))
    got = got.float()
    off = got != want
    return bool((got - want).abs()[off].le(
        2.0 ** -7 * want.abs()[off] + 1e-30).all()) \
        and int(off.sum()) <= max(1, want.numel() // 1000)


def _rounded_close(got: torch.Tensor, want) -> bool:
    """bf16 rows of fp32 activations: each entry within the fp32 limit
    (``TOL`` of the largest entry) plus one bf16 step of itself, the most
    that rounding activations equal to ``TOL`` can leave."""
    want = torch.as_tensor(np.asarray(want).astype(np.float32))
    err = (got.float() - want).abs()
    return bool(err.le(2.0 ** -7 * want.abs()
                       + TOL * want.abs().max()).all())


def _carry(jtree):
    """A reference cache tree as the port's (bf16 leaves stay bf16)."""
    return convert.lm_params(jtree)


@pytest.mark.parametrize("name", NAMES)
def test_decode_attention_matches_reference(name):
    jcfg, tcfg = jsmoke_config(name), smoke_config(name)
    window = jcfg.sliding_window          # a windowed layer where there is one
    jp = jax.tree.map(lambda a: a[0], _params(name)["pos0"]["attn"])
    tp = convert.lm_params(jp)
    jac, tac = jcfg.attn_cfg(window), tcfg.attn_cfg(window)
    b, s, steps = 2, 16, 12
    rng = np.random.default_rng(0)
    jdecode = jax.jit(jattn.decode_attention, static_argnums=(1, 2))
    jcache = jattn.init_kv_cache(b, s, jac)
    tcache = tattn.init_kv_cache(b, s, tac)
    assert all(tcache[kk].dtype == torch.bfloat16 for kk in ("k", "v"))
    for t in range(steps):
        x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        tcache = _carry(jcache)
        jout, jcache = jdecode(jp, jac, jcfg.ptc, jnp.asarray(x), jcache,
                               jnp.asarray(t, jnp.int32))
        tout, tcache = tattn.decode_attention(tp, tac, tcfg.ptc,
                                              torch.from_numpy(x), tcache, t)
        assert tout.shape == jout.shape
        assert _rel(tout, jout) < TOL, (t, _rel(tout, jout))
        for kk in ("k", "v"):
            assert _bf16_cache_close(tcache[kk], jcache[kk]), (t, kk)


@pytest.mark.parametrize("name", NAMES + FAMILIES)
def test_serve_step_matches_reference(name):
    jcfg, tcfg = jsmoke_config(name), smoke_config(name)
    jp = _params(name)
    tp = convert.lm_params(jp)
    b, steps = 3, 12
    toks = lm_batch(2, 0, b, steps, jcfg.vocab)["tokens"]
    jstep = jax.jit(jlm.build_serve_step(jcfg))
    tstep = tlm.build_serve_step(tcfg)
    jcache = jlm.init_decode_cache(jcfg, b, steps)
    tcache = tlm.init_decode_cache(tcfg, b, steps, device="cpu")
    assert set(tcache) == set(jcache)
    for pos in jcache:
        assert set(tcache[pos]) == set(jcache[pos])
        for kk in jcache[pos]:
            assert tcache[pos][kk].shape == jcache[pos][kk].shape
            assert str(tcache[pos][kk].dtype).replace("torch.", "") == \
                str(jcache[pos][kk].dtype)
    ties = 0
    for t in range(steps):
        tcache = _carry(jcache)
        jl, jcache = jstep(jp, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.asarray(t, jnp.int32)})
        tl, tcache = tstep(tp, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "cache_len": t})
        assert tl.shape == jl.shape == (b, jcfg.vocab)
        tie = False
        for pos in jcache:
            if "h" in jcache[pos]:
                assert _rel(tcache[pos]["h"], jcache[pos]["h"]) < TOL, \
                    (t, pos)
                assert _rounded_close(tcache[pos]["conv"],
                                      jcache[pos]["conv"]), (t, pos)
                continue
            for kk in ("k", "v"):
                assert _bf16_cache_close(tcache[pos][kk], jcache[pos][kk]), \
                    (t, pos, kk)
                tie |= not torch.equal(tcache[pos][kk].float(), torch.as_tensor(
                    np.asarray(jcache[pos][kk]).astype(np.float32)))
        ties += tie
        assert _rel(tl, jl) < (TIE_TOL if tie else TOL), (t, _rel(tl, jl))
    assert ties <= steps // 3


def test_serve_step_with_bf16_bases_matches_reference():
    jcfg = dataclasses.replace(jsmoke_config("falcon-mamba-7b"), ptc=jlayers.
                               PTCLinearCfg(k=8, base_dtype=jnp.bfloat16))
    tcfg = dataclasses.replace(smoke_config("falcon-mamba-7b"), ptc=tlayers.
                               PTCLinearCfg(k=8, base_dtype=torch.bfloat16))
    jp = jlm.init_model(jax.random.PRNGKey(1), jcfg)
    tp = convert.lm_params(jp)
    toks = lm_batch(2, 0, 3, 6, jcfg.vocab)["tokens"]
    jstep = jax.jit(jlm.build_serve_step(jcfg))
    tstep = tlm.build_serve_step(tcfg)
    jcache = jlm.init_decode_cache(jcfg, 3, 6)
    for t in range(6):
        tcache = _carry(jcache)
        jl, jcache = jstep(jp, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]),
            "cache_len": jnp.asarray(t, jnp.int32)})
        tl, tcache = tstep(tp, tcache, {
            "token": torch.from_numpy(toks[:, t:t + 1]), "cache_len": t})
        assert tl.dtype == torch.bfloat16
        assert _rel(tl.float(), np.asarray(jl, np.float32)) < 2e-2, t
        assert _rel(tcache["pos0"]["h"], jcache["pos0"]["h"]) < 2e-2, t


def _greedy(name, prompt, gen, **kw):
    """(reference tokens, port tokens, reference preds, port preds)."""
    jcfg, tcfg = jsmoke_config(name), smoke_config(name)
    jp = _params(name)
    b, n = prompt.shape
    jpreds, tpreds = [], []
    jgen, _ = j_greedy_decode(jax.jit(jlm.build_serve_step(jcfg)), jp,
                              jlm.init_decode_cache(jcfg, b, n + gen),
                              prompt, gen, preds_out=jpreds, **kw)
    tgen, _ = greedy_decode(tlm.build_serve_step(tcfg),
                            convert.lm_params(jp),
                            tlm.init_decode_cache(tcfg, b, n + gen,
                                                  device="cpu"),
                            prompt, gen, preds_out=tpreds, **kw)
    return jgen, tgen, np.stack(jpreds, 1), np.stack(tpreds, 1)


@pytest.mark.parametrize("name", NAMES + FAMILIES)
def test_greedy_decode_matches_reference(name):
    prompt = lm_batch(0, 0, 3, 6, 256)["tokens"]
    jgen, tgen, jpreds, tpreds = _greedy(name, prompt, 10)
    assert tgen.dtype == np.int32 and tgen.shape == (3, 10)
    assert np.array_equal(tgen, jgen)
    assert np.array_equal(tpreds, jpreds)


def test_greedy_decode_eos_early_termination():
    """As ``tests/test_serving_gateway.py``'s EOS check: the first token
    emitted becomes the stop token; the row is eos-padded and the loop
    exits right after that emission, on both packages."""
    prompt = np.asarray([[7, 3, 11]], np.int32)
    jfree, tfree, _, _ = _greedy("qwen3-4b", prompt, 6)
    assert np.array_equal(tfree, jfree)
    eos = int(tfree[0][0])
    jgen, tgen, _, _ = _greedy("qwen3-4b", prompt, 6, eos_id=eos)
    assert np.array_equal(tgen, jgen)
    assert list(tgen[0]) == [eos] * 6
    tcfg, tsteps = smoke_config("qwen3-4b"), []
    greedy_decode(tlm.build_serve_step(tcfg),
                  convert.lm_params(_params("qwen3-4b")),
                  tlm.init_decode_cache(tcfg, 1, 9, device="cpu"), prompt, 6,
                  eos_id=eos, on_step=tsteps.append)
    assert len(tsteps) == prompt.shape[1]     # prompt_len-1 prefill + 1 emit
    # a second row that never emits the stop token keeps the loop running
    two = np.concatenate([prompt, [[5, 9, 2]]]).astype(np.int32)
    jgen, tgen, _, _ = _greedy("qwen3-4b", two, 6, eos_id=eos)
    assert np.array_equal(tgen, jgen)


def test_refuses_a_layer_execution_plane():
    """``greedy_decode(layer_exec=)`` runs the plane's protocol: its hook
    installed for the whole decode, every step inside ``step(i)``.  A
    hook that keeps every layer digital leaves the tokens as they were."""
    tcfg = smoke_config("qwen3-4b")
    params = tlm.init_model(torch.Generator().manual_seed(0), tcfg)
    prompt = lm_batch(0, 0, 2, 4, 256)["tokens"]

    class Plane:
        def __init__(self):
            self.steps, self.names = [], []
            self.open = False

        def hook(self, name, p, x, cfg, d_out):
            assert self.open
            self.names.append(name)
            return None

        @contextlib.contextmanager
        def step(self, i):
            self.open = True
            yield
            self.open = False
            self.steps.append(i)

    plane = Plane()
    got, _ = greedy_decode(tlm.build_serve_step(tcfg), params,
                           tlm.init_decode_cache(tcfg, 2, 9, device="cpu"),
                           prompt, 5, layer_exec=plane)
    want, _ = greedy_decode(tlm.build_serve_step(tcfg), params,
                            tlm.init_decode_cache(tcfg, 2, 9, device="cpu"),
                            prompt, 5)
    assert np.array_equal(got, want)
    assert plane.steps == list(range(8))
    per_step = len(plane.names) // 8
    assert per_step == 7 * tcfg.n_layers and len(set(plane.names)) == per_step


def _solo_equals_gateway(name, chunk):
    cfg = smoke_config(name)
    params = tlm.init_model(torch.Generator().manual_seed(3), cfg)
    reqs = poisson_workload(2, 4, 0.7, cfg.vocab, prompt_len=(3, 10),
                            max_new=(2, 5))
    rep = ServingGateway(cfg, params, GatewayConfig(
        slots=2, pages=PageConfig(4, 32, 6), prefill_chunk=chunk,
        kv_block=4 if chunk > 1 else None), device="cpu").run(reqs)
    for r, got in zip(reqs, rep["requests"]):
        out = serve.run(argparse.Namespace(
            arch=cfg, batch=1, prompt_len=r.prompt_len, gen=r.max_new,
            seed=0, device="cpu", params_override=params,
            prompt_tokens=np.asarray(r.prompt)[None]))
        assert [int(t) for t in out["gen"][0]] == got["tokens"]


@pytest.mark.parametrize("chunk", [1, 4])
def test_solo_tokens_equal_gateway_tokens(chunk):
    """Every request served alone (batch 1, greedy) emits the tokens the
    continuous-batching gateway emits for it."""
    _solo_equals_gateway("qwen3-4b", chunk)


def test_solo_tokens_equal_gateway_tokens_for_falcon_mamba():
    """The same at chunk 1 for an ssm arch: four requests over two slots,
    so each slot serves a second request from a zeroed SSM state."""
    _solo_equals_gateway("falcon-mamba-7b", 1)


def test_serve_cli_runs_falcon_mamba_on_the_cpu(capsys):
    assert serve.main(["--arch", "smoke:falcon-mamba-7b", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen",
                       "3"]) == 0
    assert "generated (2, 3) tokens" in capsys.readouterr().out
    assert serve.main(["--arch", "smoke:falcon-mamba-7b", "--device", "cpu",
                       "--gateway", "--requests", "3"]) == 0
    assert "3 requests" in capsys.readouterr().out


def test_serve_run_and_cli_on_the_cpu(capsys):
    out = serve.run(argparse.Namespace(arch="smoke:qwen3-4b", batch=2,
                                       prompt_len=5, gen=4, seed=0,
                                       device="cpu", trace_logits=True))
    assert out["gen"].shape == (2, 4) and out["preds"].shape == (2, 8)
    assert out["logits"].shape == (8, 2, 256)
    assert np.array_equal(out["preds"], out["logits"].argmax(-1).T)
    assert np.array_equal(out["gen"], out["preds"][:, 4:])
    assert out["tokens_per_s"] > 0
    assert serve.main(["--arch", "smoke:qwen3-4b", "--device", "cpu",
                       "--batch", "1", "--prompt-len", "3", "--gen",
                       "2"]) == 0
    assert "generated (1, 2) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--hw-logits"], "need --fleet"),
    (["--fleet", "1", "--hw-logits", "--hw-shadow"], "exclusive"),
    (["--arch", "smoke:qwen3-moe-30b-a3b", "--fleet", "1", "--hw-logits"],
     "MoE"),
])
def test_cli_refuses_fleet_and_hardware_flags(flags, match):
    """The reference's refusals: the hw flags need a fleet and exclude
    each other; MoE experts cannot reach the hook."""
    with pytest.raises(ValueError, match=match):
        serve.main(["--arch", "smoke:qwen3-4b", "--device", "cpu",
                    "--batch", "1", "--prompt-len", "2", "--gen", "1",
                    *flags])


@pytest.mark.parametrize("flags,transport", [
    (["--fleet", "1"], "subprocess"),
    (["--fleet", "1", "--hw-logits", "--fleet-k", "8"], "socket"),
])
def test_cli_fleet_driver_serves_as_the_twin(flags, transport, capsys):
    """``--fleet-driver subprocess|socket`` serves through a server child
    per chip and prints the twin transport's tokens and fleet report."""
    base = ["--arch", "smoke:qwen3-4b", "--device", "cpu", "--batch", "1",
            "--prompt-len", "3", "--gen", "2", *flags]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as tests/test_torch_hw_serve.py does
    try:
        outs = []
        for driver in ("twin", transport):
            assert serve.main(base + ["--fleet-driver", driver]) == 0
            outs.append([ln for ln in capsys.readouterr().out.splitlines()
                         if "tok/s" not in ln and "tokens/s" not in ln
                         and " ms" not in ln])
    finally:
        torch.set_num_threads(threads)
    assert outs[0] == outs[1] and any("fleet:" in ln for ln in outs[0])


def test_cli_serves_through_the_fleet(capsys):
    """``--fleet`` (synthetic traffic) and ``--hw-logits`` print the fleet
    report; every decode step is a tick."""
    base = ["--arch", "smoke:qwen3-4b", "--device", "cpu", "--batch", "1",
            "--prompt-len", "3", "--gen", "2", "--fleet", "2"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as tests/test_torch_hw_serve.py does
    try:
        assert serve.main(base + ["--fleet-tenants", "2", "--drift"]) == 0
        out = capsys.readouterr().out
        assert "fleet: 2 chips x 2 tenant(s), 4 ticks" in out
        assert serve.main(base + ["--hw-logits", "--fleet-k", "8"]) == 0
        out = capsys.readouterr().out
    finally:
        torch.set_num_threads(threads)
    assert "hw-logits [route]: 14 PTC layers as tenants" in out
    assert "0 shadow matmuls, 0 dropped passes" in out
