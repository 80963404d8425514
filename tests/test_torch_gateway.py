"""Port parity: ``repro_torch.serving`` (the digital gateway, on the CPU)
against ``repro.serving`` on the same requests with the same parameters
(the reference's ``init_model``, carried over by ``convert.lm_params``).

At prefill chunk 1 and 4 (and chunk 4 advancing 2 tokens a step) the two
gateways emit the same tokens for every request and report the same
steps, busy steps, TTFT and latency in steps, and the same
admission/finish trace; so do they for ``smoke:falcon-mamba-7b`` at chunk
1 (per-slot SSM states, zeroed on admission).  Both refuse MoE archs,
and chunked prefill of ssm archs.  The CLI serves through a fleet with
``--hw-logits`` and refuses the hw flags without one, as the reference's
does.
"""

import argparse
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models.lm import init_model
from repro.serving import engine as jengine
from repro.serving import kv_pages as jkv
from repro.serving import scheduler as jsched
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.serving import engine as tengine
from repro_torch.serving import gateway as tgateway
from repro_torch.serving import kv_pages as tkv
from repro_torch.serving import scheduler as tsched

WORKLOAD = dict(seed=4, n_requests=7, rate=0.7)
LENGTHS = dict(prompt_len=(3, 14), max_new=(2, 8))


@functools.lru_cache(maxsize=None)
def _params(name):
    return init_model(jax.random.PRNGKey(1), jsmoke_config(name))


def _serve(kv, sched, engine, cfg, params, chunk, stride, device=None):
    gcfg = engine.GatewayConfig(
        slots=3, pages=kv.PageConfig(page_size=4, n_pages=40,
                                     max_pages_per_slot=8),
        prefill_chunk=chunk, prefill_stride=stride,
        kv_block=4 if chunk > 1 else None)
    reqs = sched.poisson_workload(WORKLOAD["seed"], WORKLOAD["n_requests"],
                                  WORKLOAD["rate"], cfg.vocab, **LENGTHS)
    kw = {} if device is None else {"device": device}
    return engine.ServingGateway(cfg, params, gcfg, **kw).run(reqs)


@pytest.mark.parametrize("name,chunk,stride", [
    ("qwen3-4b", 1, None), ("qwen3-4b", 4, None), ("qwen3-4b", 4, 2),
    ("gemma2-27b", 4, None), ("falcon-mamba-7b", 1, None)])
def test_gateway_matches_reference(name, chunk, stride):
    jp = _params(name)
    want = _serve(jkv, jsched, jengine, jsmoke_config(name), jp, chunk,
                  stride)
    got = _serve(tkv, tsched, tengine, smoke_config(name),
                 convert.lm_params(jp), chunk, stride, device="cpu")
    assert [r["tokens"] for r in got["requests"]] == \
        [r["tokens"] for r in want["requests"]]
    for key in ("steps", "busy_steps", "tokens_out", "ttft_steps",
                "latency_steps", "admission_wait_steps", "schedule_trace"):
        assert got[key] == want[key], key
    assert all(r["n_out"] == r["max_new"] for r in got["requests"])


def test_falcon_mamba_gateway_logits_match_reference_every_step():
    """Every step's logits, every slot: each admitted slot's SSM state is
    zeroed as the reference zeroes it, and idle slots advance on padding
    as the reference's do (tokens alone would not show a stale state: it
    decays within a few prompt tokens)."""
    jp = _params("falcon-mamba-7b")
    seen = {"j": [], "t": []}

    def recording(side, gw):
        step_fn = gw._step_fn

        def step(prm, views, batch):
            logits, new = step_fn(prm, views, batch)
            seen[side].append(np.asarray(logits, np.float32))
            return logits, new
        gw._step_fn = step
        return gw

    for side, kv, sched, engine, cfg, params, kw in (
            ("j", jkv, jsched, jengine, jsmoke_config("falcon-mamba-7b"), jp,
             {}),
            ("t", tkv, tsched, tengine, smoke_config("falcon-mamba-7b"),
             convert.lm_params(jp), {"device": "cpu"})):
        gcfg = engine.GatewayConfig(slots=2, pages=kv.PageConfig(
            page_size=4, n_pages=40, max_pages_per_slot=8))
        reqs = sched.poisson_workload(3, 5, 0.9, cfg.vocab,
                                      prompt_len=(1, 3), max_new=(2, 4))
        recording(side, engine.ServingGateway(cfg, params, gcfg, **kw)).run(
            reqs)
    assert len(seen["t"]) == len(seen["j"]) > 0
    got, want = np.stack(seen["t"]), np.stack(seen["j"])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_reset_slot_zeroes_one_slot_of_every_ssm_state():
    cfg = smoke_config("jamba-1.5-large-398b")
    gw = tengine.ServingGateway(dataclasses.replace(cfg, n_experts=0), {},
                                tengine.GatewayConfig(slots=3),
                                device="cpu")
    assert set(gw._pools) == {"pos0"} and len(gw._ssm) == 7
    for st in gw._ssm.values():
        for a in st.values():
            a.fill_(1.0)
    gw._reset_slot(1)
    for st in gw._ssm.values():
        for a in st.values():
            assert a.shape[:2] == (2, 3)
            assert float(a[:, 1].abs().max()) == 0.0
            assert float(a[:, 0].min()) == float(a[:, 2].min()) == 1.0


def test_gateway_refuses_what_the_reference_refuses():
    for name, chunk, match in (("qwen3-moe-30b-a3b", 1, "MoE"),
                               ("falcon-mamba-7b", 4, "attention-only")):
        for engine, cfg, kw in ((jengine, jsmoke_config(name), {}),
                                (tengine, smoke_config(name),
                                 {"device": "cpu"})):
            gcfg = engine.GatewayConfig(slots=2, prefill_chunk=chunk)
            with pytest.raises(ValueError, match=match):
                engine.ServingGateway(cfg, {}, gcfg, **kw)


def test_cli_runs_on_the_cpu_and_refuses_hardware_flags(capsys):
    """The CLI serves on the CPU digitally and through a one-chip fleet
    with ``--hw-logits`` (the report's fleet lines), and refuses the hw
    flags without a fleet, as the reference does."""
    assert tgateway.main(["--arch", "smoke:qwen3-4b", "--device", "cpu",
                          "--requests", "3", "--prefill-chunk", "4"]) == 0
    assert "3 requests" in capsys.readouterr().out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # as tests/test_torch_hw_gateway.py does
    try:
        assert tgateway.main(["--arch", "smoke:qwen3-4b", "--device", "cpu",
                              "--requests", "1", "--max-new", "2", "2",
                              "--fleet", "1", "--hw-logits", "--fleet-k",
                              "8"]) == 0
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "gateway [route, cpu]" in out and "1 requests" in out
    per_step = 4 * smoke_config("qwen3-4b").n_layers   # qkv, wo, gateup, down
    assert "fleet: 1 chips" in out \
        and f"coalesced frames ({per_step:.1f}/step)" in out
    for flags in (["--hw-logits"], ["--hw-shadow"]):
        with pytest.raises(ValueError, match="need --fleet"):
            tgateway.main(["--arch", "smoke:qwen3-4b", "--device", "cpu",
                           *flags])


def test_run_serves_given_params_and_requests():
    cfg = smoke_config("olmo-1b")
    params = convert.lm_params(init_model(jax.random.PRNGKey(2),
                                          jsmoke_config("olmo-1b")))
    reqs = tsched.poisson_workload(0, 2, 1.0, cfg.vocab, prompt_len=(2, 5),
                                   max_new=(3, 3))
    args = argparse.Namespace(
        arch="smoke:olmo-1b", seed=0, device="cpu", slots=2, page_size=4,
        pages=8, max_pages_per_slot=2, prefill_chunk=2,
        params_override=params, requests_override=reqs)
    rep = tgateway.run(args)
    assert rep["config"]["device"] == "cpu" and rep["tokens_out"] == 6
    assert np.all([r["finish_reason"] == "max_new" for r in rep["requests"]])
