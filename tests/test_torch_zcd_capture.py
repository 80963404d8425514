"""Port: a repair's CUDA graphs and the launch counters, beside other work.

On the card a repair's ZCD captures each half's step as a CUDA graph and
replays it (``repro_torch.hw.jobs._alternate_zcd``); a socket server runs
one thread a session.  The capture is thread-local and counts its launches
into its own thread's tally, which each replay adds:

* on any host, a thread's tally takes that thread's launches only, and
  the launches of other threads, made meanwhile, reach the counters;
* on the card (marked ``cuda``, skipped without one), one server session
  runs ZCD repairs while another sends forwards: both give the bits of the
  same sessions run one after the other, and the server's launch report
  is the same.  The file imports neither ``jax`` nor the reference::

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_zcd_capture.py
"""

import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from repro_torch.kernels import build

K = 8
M = N = 64
B = (M // K) * (N // K)          # 64 blocks, as one projection of the fleet
REPAIRS = 4


def _deltas(before: dict) -> dict:
    return {k: v - before[k] for k, v in build.launch_counts.items()
            if v != before[k]}


def test_a_capture_tallies_its_own_thread_only():
    before = dict(build.launch_counts)
    with build.tally_launches() as tally:
        build.count_launch("mesh_apply")
        build.count_launch("mesh_apply")
        other = threading.Thread(target=build.count_launch,
                                 args=("ptc_block_matmul",))
        other.start()
        other.join()
        build.count_launch("ptc_block_matmul_perblock")
    assert tally == {"mesh_apply": 2, "ptc_block_matmul_perblock": 1}
    assert _deltas(before) == {"ptc_block_matmul": 1}
    build.count_launch("mesh_apply")                 # the block is closed
    for _ in range(2):                               # two replays
        build.add_launches(tally)
    assert _deltas(before) == {"mesh_apply": 5, "ptc_block_matmul": 1,
                               "ptc_block_matmul_perblock": 2}


def _daemon():
    """A ``--socket`` server on the card that exits after two sessions."""
    from repro_torch.hw.subprocess_driver import (open_spool, server_env,
                                                  stderr_tail)
    spool = open_spool()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.hw.server", "--socket",
         "127.0.0.1:0", "--device", "cuda", "--sessions", "2"],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE, stderr=spool,
        env=server_env())
    line = proc.stdout.readline().decode()
    if not line.startswith("LISTENING "):
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(line + stderr_tail(spool))
    return proc, spool, ("127.0.0.1", int(line.split()[1]))


def _sessions(concurrent: bool, n_batches: int | None = None):
    """Session a: ``REPAIRS`` ZCD repairs; session b: batches of eight
    forwards, while a runs (until it ends) or after it (``n_batches``).
    Returns a's results, b's outputs, whether a b batch ended while a
    repaired, and the server's launch report."""
    from repro_torch.core import unitary as un
    from repro_torch.core.noise import DEFAULT_NOISE
    from repro_torch.hw import jobs, wire_key
    from repro_torch.hw.socket_driver import SocketDriver
    from repro_torch.hw.subprocess_driver import collect_launches
    from repro_torch.optim.zo import ZOConfig

    gen = torch.Generator().manual_seed(5)
    key = wire_key(gen)
    t = un.mesh_spec(K, "clements").n_rot
    cfg = ZOConfig(steps=40, inner=2 * t, delta0=0.02, decay=1.02)
    w = torch.randn((B, K, K), generator=gen)
    draws = [jobs.job_draws(gen, "zcd", B, cfg.steps, t)
             for _ in range(REPAIRS)]
    x = torch.randn((16, K), generator=gen)
    model = DEFAULT_NOISE.post_ic()
    proc, spool, address = _daemon()
    try:
        a = SocketDriver(key, B, K, model, m=M, n=N, address=address,
                         device="cuda")
        b = SocketDriver(key, B, K, model, m=M, n=N,
                         address=address, device="cuda")
        results, outs, window = [], [], []
        done = threading.Event()

        def repairs():
            try:
                window.append(time.perf_counter())
                for r in range(REPAIRS):
                    results.append(a.zo_refine(w, None, cfg,
                                               draws=draws[r]))
                window.append(time.perf_counter())
            finally:
                done.set()

        def forwards():
            while (not done.is_set() if n_batches is None
                   else len(outs) < n_batches):
                ys = b.run_batch([("forward", dict(x=x))] * 8)
                outs.append((time.perf_counter(), [y.cpu() for y in ys]))

        if concurrent:
            ta = threading.Thread(target=repairs)
            ta.start()
            forwards()
            ta.join()
        else:
            repairs()
            forwards()
        a.close()
        b.close()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    report = collect_launches(spool)
    spool.close()
    os.unlink(spool.name)
    overlap = len(window) == 2 and any(window[0] < at < window[1]
                                       for at, _ in outs)
    return results, [ys for _, ys in outs], overlap, report


@pytest.mark.cuda
def test_a_repair_beside_forwards_in_one_server():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a repair's CUDA graphs and the "
                    "kernels have no CPU mode")
    build.build(["mesh_apply", "ptc_block_matmul"])
    got, outs, overlap, report = _sessions(concurrent=True)
    assert overlap, "no forward batch ended while the repairs ran"
    want, want_outs, _, want_report = _sessions(False, n_batches=len(outs))
    for g, e in zip(got, want, strict=True):
        assert g.steps == e.steps
        assert all(torch.equal(p.cpu(), q.cpu())
                   for p, q in zip(g[:3], e[:3]))
    assert all(torch.equal(y, e) for ys in outs
               for y, e in zip(ys, want_outs[0], strict=True))
    assert report == want_report
    assert report["mesh_apply"] >= REPAIRS * (2 + 2 * 40)
