"""Port parity: the hardware-in-the-loop gateway (``repro_torch.serving``
with ``hw_plane``) against the reference's on the CPU, at the ``hwtest``
arch and workload of ``tests/test_chunked_prefill.py:240-277`` (3 slots,
3 requests, 2 chips of k = 8, σ_drift = 0, probes every 4 ticks, no
recalibration), float32 on both sides.

The reference's plane is deployed once per mode and its fleet carried
across (``convert.hw_plane``) before either gateway serves; the reference
runs first and its probe columns are injected into the port's router, so
both fleets see the same health estimates and route every pass to the
same chip.  At prefill chunk 1 and 4, routed and shadow: the same tokens
for every request, the same ``frames`` / ``frames_per_step`` /
``cols_per_frame``, and every busy step's logits within 1e-5 of the
largest, each port step reading the reference's KV views of that step
(``_lockstep``).  Both pools hold K/V in bf16: a new row whose fp32 value
sits at a bf16 rounding tie may round either way, and a step's token
attends to its own new row, so a step whose new rows hold such a flip
(each entry within one bf16 step, at most one in a thousand) is held at
5e-5, as ``tests/test_torch_serve.py`` holds such solo steps; at most a
third of the steps may have one.  At chunk 4 the port emits the chunk-1
tokens with fewer frames, still 4 a step, each wide frame carrying only
the valid columns.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import engine as jengine
from repro.serving import kv_pages as jkv
from repro.serving import scheduler as jsched
from repro_torch import convert
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_pages as tkv
from repro_torch.serving import scheduler as tsched

_DIMS = dict(name="hwtest", family="dense", n_layers=1, d_model=32,
             n_heads=2, n_kv_heads=1, d_ff=48, vocab=64, head_dim=16,
             remat=False)
JARCH = jlm.ArchConfig(**_DIMS, unroll=True,
                       ptc=jlayers.PTCLinearCfg(k=8, base_dtype=jnp.float32))
ARCH = tlm.ArchConfig(**_DIMS,
                      ptc=tlayers.PTCLinearCfg(k=8, base_dtype=torch.float32))
SEED, SLOTS, CHIPS = 5, 3, 2
TOL = 1e-5
TIE_TOL = 5e-5      # a step whose new bf16 K/V rows hold a rounding tie


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
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _requests():
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, ARCH.vocab, size=(int(rng.integers(6, 14)),))
             .astype(np.int32)) for i in range(3)]


def _args():
    return argparse.Namespace(seed=SEED, fleet=CHIPS, drift=False,
                              drift_sigma=0.0, probe_every=4, fleet_k=8,
                              fleet_driver="twin", deploy_zo=False)


def _recording(router):
    """Wrap the reference router's probe scoring to keep each chip's
    columns."""
    cols = {c.chip_id: [] for c in router.chips}
    score = router._score_probe

    def record(chip, x, y_hat):
        cols[chip.chip_id].append(np.asarray(x, np.float32))
        return score(chip, x, y_hat)

    router._score_probe = record
    return cols


def _injecting(router, cols):
    """Make the port router draw the reference's probe columns."""
    draw = router._draw_probe

    def inject(chip):
        queue = cols[chip.chip_id]
        return torch.from_numpy(queue.pop(0)) if queue else draw(chip)

    router._draw_probe = inject


def _bf16(a) -> torch.Tensor:
    """A reference array (any float dtype) as a bf16 tensor."""
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        torch.bfloat16)


def _lockstep(jgw, tgw):
    """Keep every busy step's logits and new K/V rows of both gateways, and
    step the port from the reference's KV views of the same step."""
    jlog, tlog, views = [], [], []
    jstep, tstep = jgw._step_fn, tgw._step_fn

    def jlogged(params, v, batch):
        views.append(v)
        logits, new_kv = jstep(params, v, batch)
        jlog.append((np.asarray(jnp.asarray(logits, jnp.float32)), new_kv))
        return logits, new_kv

    def tlogged(params, v, batch):
        ref = views[len(tlog)]
        v = {name: {kk: _bf16(ref[name][kk]) for kk in kv}
             for name, kv in v.items()}
        logits, new_kv = tstep(params, v, batch)
        tlog.append((logits.float().numpy(), new_kv))
        return logits, new_kv

    jgw._step_fn, tgw._step_fn = jlogged, tlogged
    return jlog, tlog


def _bf16_rows_close(got: torch.Tensor, want) -> tuple[bool, bool]:
    """(equal, close) for a step's new fp32 K/V rows as the pools store
    them, rounded to bf16: equal, or equal but for at most one entry in a
    thousand, each within one bf16 step (a tie rounded the other way)."""
    want = _bf16(want).float()
    got = got.to(torch.bfloat16).float()
    off = got != want
    close = bool((got - want).abs()[off].le(
        2.0 ** -7 * want.abs()[off] + 1e-30).all()) \
        and int(off.sum()) <= max(1, want.numel() // 1000)
    return not bool(off.any()), close


@functools.lru_cache(maxsize=None)
def _serve(mode: str, chunk: int):
    """(reference report, its logits, port report, its logits)."""
    tp = tlm.init_model(torch.Generator().manual_seed(SEED), ARCH)
    jp = _jax_tree(tp)
    rcfg = jserve._hw_runtime_config(_args())
    key = jax.random.split(jax.random.PRNGKey(SEED + 17))[1]
    jplane = jengine.build_gateway_hw_plane(
        key, JARCH, jp, rcfg, CHIPS, slots=SLOTS, mode=mode, seed=SEED,
        recal_enabled=False)
    tplane = convert.hw_plane(jplane, convert.runtime_config(rcfg),
                              seed=SEED, recal_enabled=False,
                              drift=convert.drift_config(rcfg.drift))
    reqs = _requests()
    gws = []
    for eng, kv, cfg, params, plane, kw in (
            (jengine, jkv, JARCH, jp, jplane, {}),
            (tengine, tkv, ARCH, tp, tplane, {"device": "cpu"})):
        gcfg = eng.GatewayConfig(
            slots=SLOTS, pages=kv.PageConfig(page_size=4, n_pages=24,
                                             max_pages_per_slot=4),
            prefill_chunk=chunk)
        gws.append(eng.ServingGateway(cfg, params, gcfg, hw_plane=plane,
                                      **kw))
    jlog, tlog = _lockstep(*gws)
    cols = _recording(jplane.router)
    out = []
    for gw, sched, logits in zip(gws, (jsched, tsched), (jlog, tlog)):
        if gw is gws[1]:
            _injecting(tplane.router, cols)
        rep = gw.run([sched.Request(rid=i, prompt=p, max_new=2, arrival=i)
                      for i, p in reqs])
        gw.close()
        out += [rep, logits]
    return tuple(out)


@pytest.mark.parametrize("mode", ["route", "shadow"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_gateway_matches_reference_from_one_deployment(mode, chunk):
    jrep, jlog, trep, tlog = _serve(mode, chunk)
    assert [r["tokens"] for r in trep["requests"]] \
        == [r["tokens"] for r in jrep["requests"]]
    assert len(tlog) == len(jlog) == trep["busy_steps"]
    ties = 0
    for (got, t_kv), (want, j_kv) in zip(tlog, jlog):
        rows = [_bf16_rows_close(t_kv[name][kk], j_kv[name][kk])
                for name in t_kv for kk in ("k", "v")]
        assert all(close for _, close in rows)
        tie = not all(equal for equal, _ in rows)
        ties += tie
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err < (TIE_TOL if tie else TOL)
    assert ties <= len(tlog) // 3
    jhw, thw = jrep["fleet"]["hw"], trep["fleet"]["hw"]
    for key in ("mode", "steps", "frames", "frames_per_step", "frame_cols",
                "cols_per_frame", "hw_calls", "shadow_calls",
                "dropped_passes"):
        assert thw[key] == jhw[key], key
    assert [c["served"] for c in trep["fleet"]["chips"]] \
        == [c["served"] for c in jrep["fleet"]["chips"]]


def test_chunked_prefill_emits_chunk1_tokens_with_fewer_frames():
    """Chunk 4 emits the chunk-1 hw tokens with fewer frames, still one
    frame a layer group a step, each wide frame carrying more than a
    column a slot but fewer than the uncompacted B·C."""
    rep_1, rep_4 = _serve("route", 1)[2], _serve("route", 4)[2]
    assert ([r["tokens"] for r in rep_4["requests"]]
            == [r["tokens"] for r in rep_1["requests"]])
    hw_1, hw_4 = rep_1["fleet"]["hw"], rep_4["fleet"]["hw"]
    assert hw_4["frames"] < hw_1["frames"]
    assert hw_4["frames_per_step"] == hw_1["frames_per_step"] == 4.0
    assert hw_1["cols_per_frame"] <= 3.0
    assert 3.0 < hw_4["cols_per_frame"] < 12.0
    assert hw_1["shadow_calls"] == hw_4["shadow_calls"] == 0
