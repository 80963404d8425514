"""Port parity: hardware-in-the-loop serving on the solo path
(``repro_torch.runtime.hw_serve``, ``greedy_decode(layer_exec=)``,
``launch.serve --hw-logits / --hw-shadow``) against the reference on the
CPU, at the reference's ``hwtest`` arch (one period, 7 PTC layers, fleet
k = 8; ``tests/test_hw_serve.py``), float32 on both sides.

* ``record_ptc_layers`` (the port's seeded parameters handed to both):
  the reference's names, groups, (m, n) and effective weights within
  1e-6, for the dense arch and for ``smoke:whisper-base`` (cross-attention's ``wq`` alone, its ``wk`` /
  ``wv`` grouped).
* One deployment: the reference plane's fleet is carried across
  (``convert.hw_plane``) before either serves; at σ_drift = 0 the routed
  and the shadow logits equal the reference's within 1e-5 of the largest
  at every step, and the tokens are equal.
* The port alone: routed ≡ shadow by tokens at σ = 0; a rerun reproduces
  tokens, logits and the fleet report bit for bit; 4 frames a step and
  the matmuls add up; a drifted run with the closed loop accounts every
  pass, and its batch repairs re-tune several tenants in one outage.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.data import lm_batch as j_lm_batch
from repro.launch import serve as jserve
from repro.launch.steps import greedy_decode as j_greedy_decode
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.runtime import hw_serve as jhw
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.launch.steps import greedy_decode
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.runtime import hw_serve as thw
from repro_torch.runtime.fleet import RuntimeConfig
from repro_torch.runtime.monitor import MonitorConfig
from repro_torch.runtime.recalibrate import RecalConfig
from repro_torch.hw import DriftConfig
from repro_torch.core.noise import DEFAULT_NOISE

_DIMS = dict(name="hwtest", family="dense", n_layers=1, d_model=32,
             n_heads=2, n_kv_heads=1, d_ff=48, vocab=64, head_dim=16,
             remat=False)
JARCH = jlm.ArchConfig(**_DIMS, unroll=True,
                       ptc=jlayers.PTCLinearCfg(k=8, base_dtype=jnp.float32))
ARCH = tlm.ArchConfig(**_DIMS,
                      ptc=tlayers.PTCLinearCfg(k=8, base_dtype=torch.float32))
EXPECTED_LAYERS = [
    "p0.s0.attn.wq", "p0.s0.attn.wk", "p0.s0.attn.wv", "p0.s0.attn.wo",
    "p0.s0.mlp.gate", "p0.s0.mlp.up", "p0.s0.mlp.down",
]
B, PROMPT, GEN, SEED = 2, 3, 3, 5
N_STEPS = PROMPT + GEN - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the port's many small ops then wait at every parallel
    region on threads the other workers hold (a 3 s run took 139 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(tree):
    """The port's parameters as the reference's (the same nesting; the
    reference's seeded init compiles for tens of seconds under x64)."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _models(tcfg):
    """(port params, the same as reference params) for ``tcfg``."""
    tp = tlm.init_model(torch.Generator().manual_seed(SEED), tcfg)
    return tp, _jax_tree(tp)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-12))


def _args(**over):
    base = dict(arch=ARCH, batch=B, prompt_len=PROMPT, gen=GEN, seed=SEED,
                fleet=1, drift=False, drift_sigma=0.0, probe_every=4,
                fleet_k=8, fleet_dim=8, fleet_tenants=1,
                fleet_driver="twin", hw_logits=False, hw_shadow=False,
                deploy_zo=False, no_recal=False, trace_logits=True,
                device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


def _record_both(jcfg, tcfg, extras_np=None):
    """Both packages' recorded layers for one seeded model."""
    tp, jp = _models(tcfg)
    batch = {"token": jnp.zeros((B, 1), jnp.int32),
             "cache_len": jnp.asarray(0, jnp.int32)}
    tbatch = {"token": torch.zeros((B, 1), dtype=torch.int64),
              "cache_len": 0}
    for key, a in (extras_np or {}).items():
        batch[key] = jnp.asarray(a)
        tbatch[key] = torch.from_numpy(a)
    want = jhw.record_ptc_layers(jlm.build_serve_step(jcfg), jp,
                                 jlm.init_decode_cache(jcfg, B, 2), batch)
    got = thw.record_ptc_layers(
        tlm.build_serve_step(tcfg), tp,
        tlm.init_decode_cache(tcfg, B, 2, device="cpu"), tbatch)
    return want, got


def _check_layers(want, got):
    assert [s.name for s in got] == [s.name for s in want]
    for w, g in zip(want, got):
        assert (g.index, g.m, g.n, g.group) == (w.index, w.m, w.n, w.group)
        assert g.w.dtype == torch.float32
        assert np.abs(g.w.numpy() - np.asarray(w.w, np.float32)).max() < 1e-6


def test_record_ptc_layers_match_reference_dense():
    want, got = _record_both(JARCH, ARCH)
    assert [s.name for s in got] == EXPECTED_LAYERS
    _check_layers(want, got)
    assert [(s.m, s.n) for s in got] == [(32, 32), (16, 32), (16, 32),
                                         (32, 32), (48, 32), (48, 32),
                                         (32, 48)]


def test_record_ptc_layers_match_reference_whisper():
    """encdec: cross-attention's ``wq`` reads the decoder state and runs
    alone, its ``wk`` / ``wv`` read the encoder's output and group."""
    jc = dataclasses.replace(jsmoke_config("whisper-base"), unroll=True,
                             ptc=jlayers.PTCLinearCfg(k=8,
                                                      base_dtype=jnp.float32))
    tc = dataclasses.replace(smoke_config("whisper-base"),
                             ptc=tlayers.PTCLinearCfg(
                                 k=8, base_dtype=torch.float32))
    enc = np.full((B, 4, tc.d_model), 0.1, np.float32)
    want, got = _record_both(jc, tc, {"enc_out": enc})
    _check_layers(want, got)
    groups = {s.name.rpartition(".")[2]: s.group for s in got
              if s.name.startswith("p0.s0.cross.")}
    assert groups["wq"] is None and groups["wo"] is None
    assert groups["wk"] == groups["wv"] == "p0.s0.cross.kv"
    assert len(got) == 11 * tc.n_layers


def _ref_plane(mode):
    """The reference's plane over the hwtest model, deployed from its
    seeded key, and the model in both packages; both modes deploy the
    same fleet."""
    tp, jp = _models(ARCH)
    plane = jserve._build_hw_plane(_args(), JARCH, jp,
                                   jlm.build_serve_step(JARCH), {}, mode)
    return plane, jp, tp


@pytest.mark.parametrize("mode", ["route", "shadow"])
def test_logits_match_reference_from_one_deployment(mode):
    jplane, jp, tp = _ref_plane(mode)
    tplane = convert.hw_plane(jplane, convert.runtime_config(
        jplane.router.cfg), seed=SEED, drift=convert.drift_config(
            jplane.router.cfg.drift))
    prompt = j_lm_batch(SEED, 0, B, PROMPT, ARCH.vocab)["tokens"]
    jl, tl = [], []
    jgen, _ = j_greedy_decode(jlm.build_serve_step(JARCH), jp,
                              jlm.init_decode_cache(JARCH, B, PROMPT + GEN),
                              prompt, GEN, layer_exec=jplane, logits_out=jl)
    tgen, _ = greedy_decode(tlm.build_serve_step(ARCH), tp,
                            tlm.init_decode_cache(ARCH, B, PROMPT + GEN,
                                                  device="cpu"),
                            prompt, GEN, layer_exec=tplane, logits_out=tl)
    assert len(tl) == len(jl) == N_STEPS
    for got, want in zip(tl, jl):
        assert _rel(got, want) < 1e-5
    assert np.array_equal(tgen, np.asarray(jgen))
    jrep, trep = jplane.report()["hw"], tplane.report()["hw"]
    for key in ("mode", "steps", "frames", "frame_cols", "hw_calls",
                "shadow_calls", "dropped_passes"):
        assert trep[key] == jrep[key], key


def test_route_equals_shadow_tokens_at_sigma0():
    route = serve.run(_args(hw_logits=True))
    shadow = serve.run(_args(hw_shadow=True))
    assert np.array_equal(route["gen"], shadow["gen"])
    assert np.array_equal(route["preds"], shadow["preds"])
    hw_r, hw_s = route["report"]["hw"], shadow["report"]["hw"]
    assert hw_r["mode"] == "route" and hw_s["mode"] == "shadow"
    assert hw_r["shadow_calls"] == 0 and hw_r["hw_calls"] > 0
    assert hw_s["hw_calls"] == 0 and hw_s["shadow_calls"] > 0
    assert np.abs(route["logits"] - shadow["logits"]).max() < 1e-4


def test_rerun_is_bit_identical_and_accounted():
    out1 = serve.run(_args(hw_logits=True))
    out2 = serve.run(_args(hw_logits=True))
    assert np.array_equal(out1["gen"], out2["gen"])
    assert np.array_equal(out1["logits"], out2["logits"])
    assert out1["report"] == out2["report"]
    rep = out1["report"]
    hw = rep["hw"]
    assert [l["name"] for l in hw["layers"]] == EXPECTED_LAYERS
    assert rep["ticks"] == N_STEPS == hw["steps"]
    # qkv + wo + gate/up + down: 4 frames a step
    assert hw["frames"] == 4 * N_STEPS and hw["frames_per_step"] == 4.0
    assert hw["hw_calls"] == len(EXPECTED_LAYERS) * N_STEPS
    assert hw["shadow_calls"] == 0 and hw["dropped_passes"] == 0
    chip = rep["chips"][0]
    assert chip["served"] == sum(t["served"] for t in chip["tenants"])
    assert all(t["served"] == N_STEPS for t in chip["tenants"])


def test_drifted_closed_loop_accounts_every_pass():
    mon = MonitorConfig(n_probes=6, alarm_threshold=0.02,
                        clear_threshold=0.01, consecutive=1)
    rcfg = RuntimeConfig(
        k=8, noise=DEFAULT_NOISE.post_ic(),
        drift=DriftConfig(sigma_phase=0.05, theta=0.01), monitor=mon,
        recal=RecalConfig(zo_steps=100, delta0=0.05),
        probe_every=2, recal_latency=1, max_concurrent_recals=1,
        driver_kind="twin", repair_batch=8)
    gen = 6          # the reference's 8 less two: 28 repairs at 4 ticks
    out = serve.run(_args(hw_logits=True, fleet=2, drift=True,
                          drift_sigma=0.05, gen=gen, runtime_cfg=rcfg))
    rep = out["report"]
    hw = rep["hw"]
    n_steps = PROMPT + gen - 1
    assert sum(c["alarms"] for c in rep["chips"]) > 0
    assert sum(c["recals"] for c in rep["chips"]) > 0
    assert hw["hw_calls"] + hw["shadow_calls"] \
        == len(EXPECTED_LAYERS) * n_steps
    assert hw["steps"] == n_steps
    # a batch repair re-tunes several alarmed tenants in one outage
    ticks = [ev["tick"] for ev in rep["events"]
             if ev["event"] == "recal_done"]
    assert len(ticks) > len(set(ticks))
