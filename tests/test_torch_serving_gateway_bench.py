"""Port parity: the ``serving_gateway`` benchmark
(``repro_torch.benchmarks.serving_gateway``) on the CPU, at small sizes.

* Its constants and every leg's workload are the reference's, bit for bit
  (``benchmarks/serving_gateway.py``), at both budgets.
* With the reference's parameters (``init_model(PRNGKey(0))``) carried
  across by ``convert.lm_params``, the digital chunked-prefill leg (C = 1,
  8 and 32 on 3 prompt-heavy requests) and one load-sweep rate give the
  reference's TTFT, busy steps, latency and admission wait in virtual
  steps exactly, and the reference's tokens.
* Within the port on 2 requests, σ = 0: the gateway's tokens equal the
  sequential batch-1 runs' on the twin transport and over the socket, and
  on the twin C = 8 emits the C = 1 tokens in fewer frames; the drift
  point completes every request.
* Every metric and gate path of ``check_regression.SPECS`` for the
  benchmark's JSON resolves on the summary the port builds, and the
  runner registers the benchmark under the reference's name and order.
"""

import jax
import numpy as np
import pytest
import torch

from benchmarks import check_regression as jcr
from benchmarks import serving_gateway as jsg
from repro.launch.train import parse_arch as j_parse_arch
from repro.models.lm import init_model as j_init_model
from repro.serving import gateway as jgateway
from repro.serving.scheduler import poisson_workload as j_workload
from repro_torch import convert
from repro_torch.benchmarks import check_regression as tcr
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks import serving_gateway as tsg
from repro_torch.configs import parse_arch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the port's many small ops then wait at every parallel
    region on threads the other workers hold (a 3 s run took 139 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    return j_init_model(jax.random.PRNGKey(0), j_parse_arch(tsg.ARCH))


@pytest.fixture(scope="module")
def params(jparams):
    return convert.lm_params(jparams)


@pytest.fixture(scope="module")
def wl():
    return tsg.workloads("quick", parse_arch(tsg.ARCH).vocab)


def _reference_workloads(budget: str, vocab: int) -> dict:
    """The reference's draws, with its arguments as ``main`` passes them
    (``benchmarks/serving_gateway.py:101-216``)."""
    quick = budget == "quick"
    n_req, max_new = (8, (12, 16)) if quick else (12, (16, 24))
    rates = [0.5, 1.0, 2.0, 4.0] if quick else [0.25, 0.5, 1.0, 2.0, 4.0,
                                                8.0]
    sweep_req = 16 if quick else 32
    sock_req, sock_new = (3, (4, 6)) if quick else (4, (6, 8))
    return dict(
        throughput=j_workload(jsg.SEED, n_req, 2.0, vocab, prompt_len=(4, 8),
                              max_new=max_new),
        socket=j_workload(jsg.SEED + 1, sock_req, 2.0, vocab,
                          prompt_len=(3, 6), max_new=sock_new),
        prefill=j_workload(jsg.SEED + 3, 6 if quick else 8, 2.0, vocab,
                           prompt_len=(24, 44), max_new=(4, 6)),
        chunk_socket=j_workload(jsg.SEED + 4, 3, 2.0, vocab,
                                prompt_len=(12, 20), max_new=(3, 4)),
        sweep={r: j_workload(jsg.SEED + 2, sweep_req, r, vocab,
                             prompt_len=(4, 8), max_new=(8, 12))
               for r in rates})


def _same_requests(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.rid, a.arrival, a.max_new, a.eos_id, a.prompt_len) == \
            (b.rid, b.arrival, b.max_new, b.eos_id, b.prompt_len)
        assert a.prompt.dtype == b.prompt.dtype
        assert np.array_equal(a.prompt, b.prompt)


def test_constants_equal_the_reference():
    for name in ("ARCH", "SEED", "FLEET", "FLEET_K", "SLOTS", "PAGE"):
        assert getattr(tsg, name) == getattr(jsg, name), name


@pytest.mark.parametrize("budget", ["quick", "normal"])
def test_workloads_equal_the_reference(budget):
    vocab = parse_arch(tsg.ARCH).vocab
    got, want = tsg.workloads(budget, vocab), _reference_workloads(budget,
                                                                   vocab)
    assert got.keys() == want.keys()
    for leg in ("throughput", "socket", "prefill", "chunk_socket"):
        _same_requests(got[leg], want[leg])
    assert list(got["sweep"]) == list(want["sweep"])
    for rate in want["sweep"]:
        _same_requests(got["sweep"][rate], want["sweep"][rate])


def _j_gateway(jparams, reqs, **kw):
    return jgateway.run(jsg._gw_args(jparams, reqs, hw=False, **kw))


def test_prefill_digital_matches_the_reference(jparams, params, wl):
    reqs = wl["prefill"][:3]
    got = tsg.prefill_digital(params, reqs, "cpu")
    assert got["identical"]
    jreqs = _reference_workloads("quick", parse_arch(tsg.ARCH).vocab)[
        "prefill"][:3]
    for c in (1, 8, 32):
        rep = _j_gateway(jparams, jreqs, chunk=c, page=tsg.PREFILL_PAGE)
        assert got["ttft"][str(c)] == rep["ttft_steps"], c
        assert got["busy_steps"][str(c)] == rep["busy_steps"], c
        assert got["outs"][str(c)] == [r["tokens"] for r in rep["requests"]]


def test_load_sweep_rate_matches_the_reference(jparams, params, wl):
    rate = 2.0
    got = tsg.load_sweep(params, {rate: wl["sweep"][rate][:6]}, "cpu")[0]
    jreqs = _reference_workloads("quick", parse_arch(tsg.ARCH).vocab)[
        "sweep"][rate][:6]
    rep = _j_gateway(jparams, jreqs)
    lat, wait = rep["latency_steps"], rep["admission_wait_steps"]
    assert got == dict(
        rate=rate, steps=rep["steps"], busy_steps=rep["busy_steps"],
        occupancy=rep["occupancy"], p50_latency_steps=lat["p50"],
        p99_latency_steps=lat["p99"], p50_wait_steps=wait["p50"],
        p99_wait_steps=wait["p99"])


@pytest.fixture(scope="module")
def legs(params, wl):
    """Every leg at a small size within the port (2 requests where the
    leg takes a workload), for the identity checks and the summary."""
    out = dict(
        throughput=tsg.throughput_leg(params, wl["throughput"][:2], "cpu"),
        socket=tsg.socket_leg(params, wl["socket"][:2], "cpu"),
        prefill_digital=tsg.prefill_digital(params, wl["prefill"][:2],
                                            "cpu"),
        prefill_twin=tsg.prefill_hw(params, wl["prefill"][:2],
                                    tsg.PREFILL_PAGE, "twin", "cpu"),
        # the socket C = 8 check starts four more server children; the
        # summary takes the twin's check in its place
        prefill_socket=None,
        load_sweep=tsg.load_sweep(params, {2.0: wl["sweep"][2.0][:2]},
                                  "cpu"),
        drift=tsg.drift_point(params, wl["throughput"][:2], "cpu"))
    out["prefill_socket"] = out["prefill_twin"]
    return out


def test_gateway_equals_sequential_on_the_twin(legs, wl):
    tp = legs["throughput"]
    assert tp["identical"] and tp["gw_outs"] == tp["seq_outs"]
    budgets = [r.max_new for r in wl["throughput"][:2]]
    assert [len(t) for t in tp["seq_outs"]] == budgets
    assert tp["seq_tokens"] == tp["gw"]["tokens_out"] == sum(budgets)


def test_chunked_prefill_on_the_twin_takes_fewer_frames(legs):
    tw = legs["prefill_twin"]
    assert tw["identical"]
    assert tw["frames_c8"] < tw["frames_c1"]
    assert tw["cols_per_frame_c8"] > tw["cols_per_frame_c1"]


def test_socket_gateway_equals_sequential(legs):
    sock = legs["socket"]
    assert sock["identical"] and len(sock["seq_outs"]) == 2


def test_drift_point_completes(legs, wl):
    drift = legs["drift"]
    assert drift["complete"]
    assert drift["tokens_out"] == sum(r.max_new for r in wl["throughput"][:2])
    assert drift["sigma"] == 0.008


@pytest.mark.parametrize("package", [tcr, jcr], ids=["port", "reference"])
def test_spec_paths_resolve_on_the_summary(legs, package):
    summary = tsg.summarize("quick", legs, {"throughput": 0.0}, "cpu")
    spec = package.SPECS["BENCH_serving_gateway.json"]
    for gate in spec["gates"]:
        assert isinstance(tcr._lookup(summary, gate), bool), gate
    for name, fn in spec["metrics"].items():
        assert np.isfinite(float(fn(summary))), name
    assert summary["gates"].keys() == {
        g.split(".", 1)[1] for g in spec["gates"]}


@pytest.mark.parametrize("got, want, where", [
    ([[1, 2, 3], [4, 5]], [[1, 2, 3], [4, 5]], None),
    ([[1, 2, 3], [4, 5]], [[1, 2, 3], [4, 6]], dict(request=1, step=1)),
    ([[1, 2]], [[1, 2, 3]], dict(request=0, step=2)),
])
def test_first_parting_names_the_request_and_step(got, want, where):
    assert tsg._first_parting(got, want) == where


def test_runner_registers_the_benchmark():
    names = [name for name, _ in bench_run.RUNTIME]
    assert ("serving_gateway", tsg.main) in bench_run.RUNTIME
    assert names.index("hw_driver_overhead") < names.index(
        "runtime_e2e_accuracy") < names.index(
        "serving_gateway") < names.index("fleet_autopilot")
    assert ("serving_gateway", tsg.main) in bench_run.BENCHES
