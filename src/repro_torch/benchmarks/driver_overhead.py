"""Driver-transport overhead: the in-process twin against the op-stream
transports.

Counterpart of ``benchmarks/driver_overhead.py``.  The control-plane ABC
costs nothing physically (the conformance tests hold every transport to
the twin's bits and meter), so the question is wall-clock: what the
hardware-in-the-loop transports add per op, and how far the v4 data plane
(``run_batch``, write pipelining, binary frames), the async client
(``run_batch_async``) and the concurrent socket server close the gap.  It
times the hot control-plane ops on ``twin``, ``subprocess`` and ``socket``
and writes under ``bench_artifacts/torch/``:

* ``driver_overhead.csv``: per-op median latency (ms) on each transport
  and its multiple of the twin's;
* ``BENCH_driver_overhead.json``: the per-op times, a batch-size sweep (1,
  8, 64 ``forward`` ops a round trip), an async overlap sweep (``depth``
  frames in flight against the same work issued synchronously) and a
  concurrent sweep (client threads sharing one ``--socket`` server).

Every sweep holds its bits: batched ≡ sequential on every transport and
every transport ≡ the twin, v4 binary ≡ pinned v3 JSON lines, async ≡
sync, each concurrent session ≡ the in-process twin.  The socket sessions
all go to one ``--socket`` server child; the subprocess transport spawns a
child for each of its two sessions (v4 and pinned v3).  Times are the median of 5 repeats, each at least
``iters`` calls and 0.25 s.  On a CUDA device the card is synchronized
after every timed call, and the server children run their twins on the
same card, so the stream transports' times include the device-to-host
copies of every result.

    PYTHONPATH=src python -m repro_torch.benchmarks.driver_overhead \\
        [--budget quick|normal] [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import statistics
import subprocess
import threading
import time

import torch

from ..core.noise import DEFAULT_NOISE
from ..device import resolve_device
from ..hw import make_driver, make_twin, wire_key, key_generator, DriftConfig
from ..hw.socket_driver import SocketDriver
from ..hw.subprocess_driver import server_args, server_env
from ..optim.zo import ZOConfig
from .common import ART, emit

__all__ = ["main", "K", "DIM", "BATCH_SIZES", "TRANSPORTS"]

K = 4
DIM = 12
BATCH_SIZES = (1, 8, 64)
TRANSPORTS = ("twin", "subprocess", "socket")
NOISE = DEFAULT_NOISE.post_ic()
DRIFT = DriftConfig(sigma_phase=0.01)


def _time_op(fn, iters: int, device, repeats: int = 5,
             min_seconds: float = 0.25) -> float:
    """Median over ``repeats`` of the mean wall seconds a call (one warm
    call first); each repeat runs at least ``iters`` calls and
    ``min_seconds``.  On the card every call ends synchronized."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def call():
        fn()
        sync()

    call()
    means = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        n = 0
        while True:
            for _ in range(iters):
                call()
            n += iters
            dt = time.perf_counter() - t0
            if dt >= min_seconds:
                break
        means.append(dt / n)
    return statistics.median(means)


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator("cpu").manual_seed(seed)


def _blocks() -> int:
    return (-(-DIM // K)) ** 2


class _Daemon:
    """One ``--socket`` server child on ``device`` for every socket session
    of the run (it exits after ``sessions`` of them).  It boots while the
    twin's and the subprocess transport's sweeps run: ``address`` waits
    for its ``LISTENING`` line on first use."""

    def __init__(self, device, sessions: int):
        self.proc = subprocess.Popen(
            server_args(device) + ["--socket", "127.0.0.1:0", "--sessions",
                                   str(sessions)],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, env=server_env())
        self._address = None

    @property
    def address(self) -> tuple[str, int]:
        if self._address is None:
            line = self.proc.stdout.readline().decode()
            if not line.startswith("LISTENING "):
                raise RuntimeError(f"socket server failed to start: {line!r}")
            self._address = ("127.0.0.1", int(line.split()[1]))
        return self._address

    def close(self) -> None:
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _make(transport: str, device, daemon, protocol: int | None = None):
    return make_driver(transport, _gen(), _blocks(), K, NOISE, m=DIM, n=DIM,
                       drift=DRIFT, device=device, protocol=protocol,
                       address=daemon.address if transport == "socket"
                       else None)


def _inputs(seed: int, device):
    g = _gen(seed)
    x_probe = torch.randn((8, K), generator=g).to(device)
    x_serve = torch.randn((16, DIM), generator=g).to(device)
    w_blocks = (0.3 * torch.randn((_blocks(), K, K), generator=g)).to(device)
    return x_probe, x_serve, w_blocks


def _equal(a, b) -> None:
    if not torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()):
        raise AssertionError("results differ across encodings, schedules or "
                             "transports")


def _check_ops(driver):
    """The op list of the bit-identity checks: a clock tick, three probes
    one by one, the same three in one batch and the commanded Σ."""
    x = _inputs(7, driver.device)[0]
    driver.advance(1.0)
    seq = [driver.forward(x) for _ in range(3)]
    bat = driver.run_batch([("forward", dict(x=x))] * 3 + [("read_sigma", {})])
    return seq, bat


def _open(transport: str, device, daemon):
    """The transport's timed session and, on a stream transport, a session
    pinned to wire v3, built at once (two server children start
    together)."""
    if transport == "twin":
        return _make(transport, device, daemon), None
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        v4, v3 = (ex.submit(_make, transport, device, daemon, p)
                  for p in (None, 3))
        return v4.result(), v3.result()


def check_bits(driver, v3, ref) -> list:
    """Batched ≡ sequential on ``driver``, the same ops ≡ ``ref`` (the
    twin's, when given), and the same ops on ``v3`` (a session pinned to
    wire v3, when given) ≡ this v4 one.  Raises on any mismatch; returns
    this driver's results."""
    seq, bat = _check_ops(driver)
    for s_, b_ in zip(seq, bat):
        _equal(s_, b_)
    got = seq + bat
    for a, b in zip(ref or got, got):
        _equal(a, b)
    if v3 is not None:
        assert driver.protocol == 4 and v3.protocol == 3
        seq3, bat3 = _check_ops(v3)
        for a, b in zip(got, seq3 + bat3):
            _equal(a, b)
    return got


def _bench_transport(driver, iters: int, zo_steps: int, device,
                     repeats: int) -> dict:
    x_probe, x_serve, w_blocks = _inputs(0, device)
    zo_cfg = ZOConfig(steps=zo_steps, inner=12, delta0=0.05, decay=1.05)
    jobs = _gen(1)

    def advance_flushed():
        # advance is pipelined on the stream transports: land it inside
        # the timed region, so every transport pays one clock tick
        driver.advance(1.0)
        driver.flush()

    def timed(fn, n):
        return _time_op(fn, n, device, repeats)

    out = dict(
        probe_s=timed(lambda: driver.forward(x_probe), iters),
        serve_s=timed(lambda: driver.forward_layer(x_serve), iters),
        readback_s=timed(lambda: driver.readback_bases(), iters),
        advance_s=timed(advance_flushed, iters),
        zo_refine_s=timed(lambda: driver.zo_refine(w_blocks, jobs, zo_cfg),
                          max(2, iters // 10)))
    out["probe_cols_per_s"] = x_probe.shape[0] / out["probe_s"]
    out["serve_rows_per_s"] = x_serve.shape[0] / out["serve_s"]
    sweep = {}
    for n_ops in BATCH_SIZES:
        ops = [("forward", dict(x=x_probe))] * n_ops
        batch_s = timed(lambda: driver.run_batch(ops),
                        max(12, iters // n_ops))
        sweep[str(n_ops)] = dict(
            batch_s=batch_s,
            probe_cols_per_s=n_ops * x_probe.shape[0] / batch_s,
            per_op_ms=batch_s / n_ops * 1e3)
    out["batch_sweep"] = sweep
    return out


def _bench_async(driver, iters: int, device, repeats: int,
                 depth: int = 4) -> dict:
    """``depth`` batch frames in flight against the same work issued
    synchronously, after an async ≡ sync check."""
    x = _inputs(0, device)[0]
    ops = [("forward", dict(x=x))] * 8
    ref = driver.run_batch(ops)
    for got, want in zip(driver.run_batch_async(ops).result(), ref):
        _equal(got, want)

    def sync_round():
        for _ in range(depth):
            driver.run_batch(ops)

    def async_round():
        futs = [driver.run_batch_async(ops) for _ in range(depth)]
        for f in futs:
            f.result()

    rounds = max(4, iters // (len(ops) * depth))
    sync_s = _time_op(sync_round, rounds, device, repeats)
    async_s = _time_op(async_round, rounds, device, repeats)
    cols = depth * len(ops) * x.shape[0]
    return dict(depth=depth, batch_ops=len(ops), sync_s=sync_s,
                async_s=async_s, sync_cols_per_s=cols / sync_s,
                async_cols_per_s=cols / async_s,
                overlap_speedup=sync_s / async_s, async_bit_identical=True)


def _bench_concurrent(n_clients: int, iters: int, device, daemon) -> dict:
    """``n_clients`` threads sharing the one ``--socket`` server, a session
    each: the aggregate probe throughput, and whether every session's
    results equal the in-process twin's."""
    key = wire_key(_gen())
    x = _inputs(0, device)[0]
    ops = [("forward", dict(x=x))] * 8
    rounds = max(6, iters // len(ops))
    twin = make_twin(key_generator(key), _blocks(), K, NOISE, m=DIM, n=DIM,
                     drift=DRIFT, device=device)
    ref = twin.forward(x)
    barrier = threading.Barrier(n_clients)
    spans = [None] * n_clients
    oks = [False] * n_clients
    errs: list = []

    def worker(i):
        try:
            driver = SocketDriver(key, _blocks(), K, NOISE, m=DIM, n=DIM,
                                  drift=DRIFT, device=device,
                                  address=daemon.address)
            try:
                out = driver.run_batch(ops)        # warm + handshake
                barrier.wait()
                t0 = time.perf_counter()
                for _ in range(rounds):
                    out = driver.run_batch(ops)
                t1 = time.perf_counter()
            finally:
                driver.close()
            spans[i] = (t0, t1)
            oks[i] = all(torch.equal(y.cpu(), ref.cpu()) for y in out)
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    wall = max(s[1] for s in spans) - min(s[0] for s in spans)
    total_cols = n_clients * rounds * len(ops) * x.shape[0]
    return dict(n_clients=n_clients, rounds=rounds, batch_ops=len(ops),
                wall_s=wall, aggregate_cols_per_s=total_cols / wall,
                per_client_cols_per_s=total_cols / wall / n_clients,
                bit_identical=all(oks))


def main(budget: str = "quick", device=None, repeats: int = 5) -> dict:
    """Every sweep on ``device``, each timing the median of ``repeats``
    repeats; returns {table: rows} and writes the CSV and the JSON.
    Raises if any bit-identity check fails."""
    dev = resolve_device(device)
    iters, zo_steps = (30, 60) if budget == "quick" else (150, 200)
    n_clients = 3
    # the socket sessions: the timed one, its pinned-v3 twin, the clients
    daemon = _Daemon(dev, 2 + n_clients)
    results, async_results, ref = {}, {}, None
    try:
        for transport in TRANSPORTS:
            driver, v3 = _open(transport, dev, daemon)
            try:
                try:
                    got = check_bits(driver, v3, ref)
                finally:
                    if v3 is not None:
                        v3.close()
                ref = ref or got
                results[transport] = dict(
                    transport=transport,
                    **_bench_transport(driver, iters, zo_steps, dev,
                                       repeats))
                if transport != "twin":
                    async_results[transport] = _bench_async(driver, iters,
                                                            dev, repeats)
                    results[transport]["frames"] = driver.rpc_count
                    results[transport]["wire_bytes"] = list(
                        driver.wire_bytes)
            finally:
                driver.close()
        daemon.address                  # resolved before the clients race
        shared = _bench_concurrent(n_clients, iters, dev, daemon)
    finally:
        daemon.close()
    if not shared["bit_identical"]:
        raise AssertionError("a concurrent socket session differs from the "
                             "in-process twin")
    tw = results["twin"]
    ops = ["probe_s", "serve_s", "readback_s", "advance_s", "zo_refine_s"]
    rows = []
    for transport in TRANSPORTS[1:]:
        sp = results[transport]
        rows += [[transport, op[:-2], f"{tw[op] * 1e3:.3f}",
                  f"{sp[op] * 1e3:.3f}", f"{sp[op] / tw[op]:.2f}"]
                 for op in ops]
        for n in BATCH_SIZES:
            tb, sb = tw["batch_sweep"][str(n)], sp["batch_sweep"][str(n)]
            rows.append([transport, f"probe_batch{n}",
                         f"{tb['per_op_ms']:.3f}", f"{sb['per_op_ms']:.3f}",
                         f"{sb['batch_s'] / tb['batch_s']:.2f}"])
    emit("driver_overhead",
         ["transport", "op", "twin_ms", "stream_ms", "overhead_x"], rows)
    summary = dict(
        budget=budget, device=str(dev), k=K, dim=DIM, iters=iters,
        zo_steps=zo_steps, repeats=repeats,
        protocol="v4 (binary frames, negotiated; batch + async + write "
                 "pipelining; v3 JSON-line fallback)",
        batch_sizes=list(BATCH_SIZES), bit_identity_ok=True,
        v4_v3_bit_identical=True,
        concurrent_bit_identical=shared["bit_identical"],
        async_sweep=async_results, concurrent=shared,
        **{t: results[t] for t in TRANSPORTS})
    for transport in TRANSPORTS[1:]:
        sp = results[transport]
        summary[f"{transport}_probe_rpc_overhead_ms"] = \
            (sp["probe_s"] - tw["probe_s"]) * 1e3
        summary[f"{transport}_probe_throughput_ratio"] = \
            sp["probe_cols_per_s"] / tw["probe_cols_per_s"]
        summary[f"{transport}_serve_throughput_ratio"] = \
            sp["serve_rows_per_s"] / tw["serve_rows_per_s"]
        summary[f"{transport}_zo_job_overhead_frac"] = max(
            0.0, sp["zo_refine_s"] / tw["zo_refine_s"] - 1.0)
        summary[f"{transport}_batched_probe_cols_per_s"] = \
            sp["batch_sweep"][str(max(BATCH_SIZES))]["probe_cols_per_s"]
    n_max = str(max(BATCH_SIZES))
    summary["socket_batch64_vs_twin_batch64"] = (
        results["socket"]["batch_sweep"][n_max]["probe_cols_per_s"]
        / tw["batch_sweep"][n_max]["probe_cols_per_s"])
    # the reference's gate: a batch-64 socket sweep within 2x of the twin's
    # own batched throughput, 4x on a one-core host (client and server then
    # share one lane)
    threshold = 0.5 if (os.cpu_count() or 1) >= 2 else 0.25
    summary["v4_socket_batch64_threshold"] = threshold
    summary["v4_socket_batch64_within_2x_twin"] = \
        summary["socket_batch64_vs_twin_batch64"] >= threshold
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / "BENCH_driver_overhead.json"
    path.write_text(json.dumps(summary, indent=2))
    print(f"--- driver_overhead summary ({path}) ---")
    print(json.dumps(summary, indent=2), flush=True)
    return {"driver_overhead": rows}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", default="quick", choices=["quick", "normal"])
    ap.add_argument("--device", default=None)
    _args = ap.parse_args()
    main(_args.budget, device=_args.device)
