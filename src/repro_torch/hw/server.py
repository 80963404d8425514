"""Out-of-process twin server: ``python -m repro_torch.hw.server``.

Counterpart of ``repro/hw/server.py``.  Hosts one :class:`TwinDriver` per
session and serves the driver protocol (v4 binary frames with a v3
JSON-line fallback, :mod:`repro_torch.hw.protocol`, specified in
``docs/wire-protocol.md``) over either

* **stdin/stdout** (the default: the :class:`SubprocessDriver` pipe
  topology), or
* **TCP** (``--socket HOST:PORT``: the :class:`SocketDriver` topology;
  ``PORT=0`` binds an ephemeral port, announced as ``LISTENING <port>`` on
  stdout).  Connections are served concurrently, one thread and one fresh
  session each; ``--max-conns N`` bounds how many run at once,
  ``--sessions N`` exits after N sessions in all.

``--device`` (default ``cuda``) is where the twin lives: on the card its
probes, serve products and realizations launch the CUDA kernels;
``--device cpu`` runs their plain versions.  ``--threads N`` sets torch's
intra-op threads (a client that spawns the server passes its own count,
so CPU results match its in-process twin's bit for bit).

A session's twin is sampled from the ``init`` frame's key (two uint32
words) by :func:`~repro_torch.hw.driver.key_generator`, so one key gives
one realization here and in the in-process twin of
:func:`~repro_torch.hw.make_driver`; the reference's client, whose key is
a raw ``jax.random`` key, is served as it is.  In-situ jobs run here, on
the frame's per-step ``draws`` (or on draws made from its ``key``).

The v3 ``batch`` op executes an ordered sub-op list in one round trip,
each sub-op through the same dispatch as a standalone frame (a run of
same-shape probe ``forward`` ops as one coalesced call), so batched ≡
sequential bit for bit and every op is metered on its own.  The
``unsafe/*`` ops back the client's ``unsafe_twin()``; a real-hardware
daemon would not implement them.

The kernel launches this process made are written to stderr at exit as
one line ``KERNEL_LAUNCHES {json}`` (:func:`launch_report`): a spawning
client reads them from the server's stderr
(:func:`~repro_torch.hw.subprocess_driver.stderr_tail`).
"""

from __future__ import annotations

import argparse
import json
import socket as _socket
import sys
import threading
import traceback

import numpy as np
import torch

from ..core.noise import NoiseModel
from ..kernels import build
from ..optim.zo import ZOConfig
from .drift import DriftConfig
from .driver import (forward_coalesce_key, coalesce_spans, BATCHABLE_OPS,
                     WIRE_INTERNAL_OPS, key_generator)
from .jobs import job_draws
from .protocol import (encode, decode, send, recv, ProtocolError,
                       PROTOCOL_VERSION, SUPPORTED_VERSIONS)
from .twin import make_twin  # repro: noqa[RPL101]

__all__ = ["serve", "serve_socket", "launch_report", "main",
           "LAUNCH_MARK"]

LAUNCH_MARK = "KERNEL_LAUNCHES "


def _build_driver(kw: dict, device):
    """Build the session driver on ``device`` from an ``init`` payload;
    returns ``(driver, negotiated_version)``.  A version outside
    ``SUPPORTED_VERSIONS`` is refused with the ``protocol mismatch``
    marker a v4 client's fallback keys on."""
    v = int(kw.get("v", 1))
    if v not in SUPPORTED_VERSIONS:
        supported = "/".join(f"v{s}" for s in SUPPORTED_VERSIONS)
        raise RuntimeError(
            f"driver protocol mismatch: client speaks v{v}, server "
            f"speaks {supported}")
    model = NoiseModel(**kw["model"])
    drift = DriftConfig(**kw["drift"]) if kw.get("drift") else None
    return make_twin(key_generator(kw["key"]), int(kw["n_blocks"]),
                     int(kw["k"]), model, kw.get("kind", "clements"),
                     m=kw.get("m"), n=kw.get("n"), drift=drift,
                     device=device), v


def _rng(kw: dict):
    br = kw.get("block_range")
    return tuple(int(i) for i in br) if br is not None else None


def _draws(driver, kw: dict, b: int, steps: int, restarts=None):
    """A job's per-step draws: the frame's ``draws``, else made from its
    ``key`` as the in-process job would make them from a generator."""
    if kw.get("draws") is not None:
        draws = torch.from_numpy(np.ascontiguousarray(kw["draws"]))
        # coordinate draws travel as int32
        return draws.long() if not draws.is_floating_point() else draws
    return job_draws(key_generator(kw["key"]), kw.get("method", "zcd"), b,
                     steps, driver.read_phases()[0].shape[-1], restarts)


def _host(y):
    """A result tensor as host numpy (the wire's form)."""
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else y


def _dispatch(driver, op: str, kw: dict):
    if op == "batch":
        # ordered sub-op list, one round trip, every sub-op through this
        # same dispatcher, except that consecutive same-shape probe
        # ``forward`` ops coalesce into one call (the same bits, charged
        # per op)
        entries = kw.get("ops") or []
        for entry in entries:
            # the in-process batch set, plus the wire-internal
            # ``forward_many``; session control, ``meta`` and ``unsafe/*``
            # stay out of batch frames
            if entry.get("op") not in BATCHABLE_OPS \
                    and entry.get("op") not in WIRE_INTERNAL_OPS:
                raise ValueError(
                    f"op {entry.get('op')!r} cannot appear inside a batch")
        keys = [forward_coalesce_key(e.get("kw") or {})
                if e.get("op") == "forward" else None for e in entries]
        results = []
        for i, j in coalesce_spans(keys):
            sub = entries[i].get("op")
            try:
                if j - i > 1:
                    kw_i = entries[i].get("kw") or {}
                    xs = np.stack([(e.get("kw") or {})["x"]
                                   for e in entries[i:j]])
                    y = driver.forward_many_stacked(
                        xs, category=kw_i.get("category", "probe"),
                        block_range=_rng(kw_i))
                    results.append(dict(coalesced=j - i, y=_host(y)))
                else:
                    results.append(
                        _dispatch(driver, sub, entries[i].get("kw") or {}))
            except Exception as e:
                raise RuntimeError(
                    f"batch op {i} ({sub!r}) failed: {e}\n"
                    f"(ops [0, {i}) were already applied)") from e
        return results
    if op == "meta":
        m, n = driver.layer_shape
        return dict(k=driver.k, kind=driver.kind, n_blocks=driver.n_blocks,
                    m=m, n=n, v=PROTOCOL_VERSION)
    if op == "write_phases":
        driver.write_phases(kw["phi_u"], kw["phi_v"], block_range=_rng(kw))
        return None
    if op == "write_sigma":
        driver.write_sigma(kw["sigma"], block_range=_rng(kw))
        return None
    if op == "write_signs":
        driver.write_signs(kw["d_u"], kw["d_v"], block_range=_rng(kw))
        return None
    if op == "read_phases":
        phi_u, phi_v = driver.read_phases()
        return dict(phi_u=_host(phi_u), phi_v=_host(phi_v))
    if op == "read_sigma":
        return dict(sigma=_host(driver.read_sigma()))
    if op == "forward":
        return dict(y=_host(driver.forward(
            kw["x"], kw.get("category", "probe"), block_range=_rng(kw))))
    if op == "forward_many":
        # a client-coalesced probe span: one stacked x in, one stacked y out
        y = driver.forward_many_stacked(
            kw["xs"], category=kw.get("category", "probe"),
            block_range=_rng(kw))
        return dict(coalesced=int(y.shape[0]), y=_host(y))
    if op == "forward_layer":
        out_dim = kw.get("out_dim")
        return dict(y=_host(driver.forward_layer(
            kw["x"], block_range=_rng(kw),
            out_dim=int(out_dim) if out_dim is not None else None)))
    if op == "readback_bases":
        u, v = driver.readback_bases(cols=kw.get("cols"),
                                     block_range=_rng(kw))
        return dict(u=_host(u), v=_host(v))
    if op == "zo_refine":
        cfg = ZOConfig(**kw["cfg"])
        start, stop = _rng(kw) or (0, driver.n_blocks)
        res = driver.zo_refine(
            kw["w_blocks"], None, cfg, method=kw.get("method", "zcd"),
            block_range=_rng(kw),
            draws=_draws(driver, kw, stop - start, cfg.steps))
        return dict(phi=_host(res.phi), loss=_host(res.loss),
                    history=_host(res.history), steps=res.steps)
    if op == "run_ic":
        cfg = ZOConfig(**kw["cfg"])
        restarts = int(kw.get("restarts", 4))
        res = driver.run_ic(None, kw["sigs"], cfg, restarts=restarts,
                            method=kw.get("method", "zcd"),
                            draws=_draws(driver, kw, driver.n_blocks,
                                         cfg.steps, restarts))
        return dict(phi=_host(res.phi), u=_host(res.u), v=_host(res.v),
                    loss=_host(res.loss), history=_host(res.history))
    if op == "advance":
        driver.advance(float(kw.get("dt", 1.0)))
        return None
    if op == "stats":
        return driver.stats.as_dict()
    if op == "reset_stats":
        driver.reset_stats()
        return None
    if op == "charge":
        driver.charge(kw["category"], float(kw["calls"]))
        return None
    # -- unsafe/* : twin-internal readouts backing unsafe_twin() -------------
    if op == "unsafe/true_mapping_distance":
        return dict(d=driver.unsafe_twin().true_mapping_distance(  # repro: noqa[RPL102]
            kw["w_blocks"], block_range=_rng(kw)))
    if op == "unsafe/bias_deviation":
        return dict(d=driver.unsafe_twin().bias_deviation())  # repro: noqa[RPL102]
    if op == "unsafe/dev":
        dev = driver.unsafe_twin().dev  # repro: noqa[RPL102]
        return dict(gamma_u=_host(dev.noise_u.gamma),
                    bias_u=_host(dev.noise_u.bias),
                    gamma_v=_host(dev.noise_v.gamma),
                    bias_v=_host(dev.noise_v.bias),
                    d_u=_host(dev.d_u), d_v=_host(dev.d_v))
    if op == "unsafe/realized_unitaries":
        u, v = driver.unsafe_twin().realized_unitaries()  # repro: noqa[RPL102, RPL103]
        return dict(u=_host(u), v=_host(v))
    raise ValueError(f"unknown op: {op!r}")


def serve(fin, fout, device="cuda") -> None:
    """One driver session over a byte-stream pair, its twin on ``device``.

    Frames arrive in either encoding; the session answers in JSON lines
    until (and including) the init reply, then in binary frames once v4
    is negotiated.  Returns when the peer shuts down, disconnects or
    breaks the framing (a malformed or oversized frame draws a
    best-effort error frame, then the connection is dropped)."""
    driver = None
    binary = False
    while True:
        try:
            req = recv(fin)
        except ProtocolError as e:
            if "closed" not in str(e):
                try:
                    send(fout, dict(id=None, ok=False,
                                    error=f"protocol error: {e}"),
                         binary=binary)
                except Exception:
                    pass
            return
        rid = None
        try:
            # a valid frame can still be a non-dict or carry a malformed
            # array node: that draws an error frame, not the session
            rid, op = req.get("id"), req.get("op")
            kw = decode(req.get("kw") or {})
            if op == "shutdown":
                send(fout, dict(id=rid, ok=True, result=None), binary=binary)
                return
            if op == "init":
                driver, v = _build_driver(kw, device)
                result = _dispatch(driver, "meta", {})
                result["v"] = v         # echo the negotiated version
                # the init reply always travels as a JSON line ...
                send(fout, dict(id=rid, ok=True, result=encode(result)))
                # ... then the session goes binary iff v4 was negotiated
                binary = v >= 4
                continue
            elif driver is None:
                raise RuntimeError("first op must be 'init'")
            else:
                result = _dispatch(driver, op, kw)
            try:
                send(fout, dict(id=rid, ok=True,
                                result=encode(result, binary=binary)),
                     binary=binary)
            except ProtocolError as e:
                # too large for one frame: send() refused before writing,
                # so the stream is still framed; the op's effects stand
                send(fout, dict(id=rid, ok=False,
                                error=f"result not sendable: {e}"),
                     binary=binary)
        except ProtocolError:
            return                      # response no longer sendable
        except OSError:
            return                      # transport died mid-response
        except Exception:
            send(fout, dict(id=rid, ok=False,
                            error=traceback.format_exc(limit=8)),
                 binary=binary)


def _serve_connection(conn, peer, lock: threading.Lock, state: dict,
                      gate, device) -> None:
    """One socket session, contained: any exception escaping it is logged
    and swallowed so the daemon keeps serving other clients."""
    try:
        try:
            with conn:
                conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
                fin = conn.makefile("rb", buffering=1 << 20)
                fout = conn.makefile("wb", buffering=1 << 20)
                try:
                    serve(fin, fout, device)
                finally:
                    try:
                        fout.flush()
                    except Exception:
                        pass
        except Exception as e:
            print(f"session from {peer} aborted: {e!r}",
                  file=sys.stderr, flush=True)
    finally:
        with lock:
            state["served"] += 1
        if gate is not None:
            gate.release()


def serve_socket(host: str = "127.0.0.1", port: int = 0, *,
                 max_conns: int | None = None,
                 sessions: int | None = None, announce=None,
                 device="cuda") -> None:
    """Serve driver sessions over TCP, one thread per connection, each
    session's twin on ``device``.

    ``port=0`` binds an ephemeral port, announced as ``LISTENING <port>``
    on ``announce`` (default stdout).  ``max_conns`` bounds how many
    sessions run at once (further accepts wait in the backlog);
    ``sessions`` stops accepting after that many in all, drains the live
    ones and returns."""
    out = announce if announce is not None else sys.stdout
    lock = threading.Lock()
    state = {"served": 0}
    gate = (threading.BoundedSemaphore(max_conns)
            if max_conns is not None else None)
    workers: list[threading.Thread] = []
    with _socket.create_server((host, port)) as srv:
        print(f"LISTENING {srv.getsockname()[1]}", file=out, flush=True)
        accepted = 0
        while sessions is None or accepted < sessions:
            if gate is not None:
                gate.acquire()
            try:
                conn, peer = srv.accept()
            except BaseException:
                if gate is not None:
                    gate.release()
                raise
            accepted += 1
            t = threading.Thread(
                target=_serve_connection, args=(conn, peer, lock, state, gate,
                                                 device),
                name=f"hw-session-{accepted}", daemon=True)
            t.start()
            workers.append(t)
            workers = [w for w in workers if w.is_alive()]
    for t in workers:                   # bounded lifetime: drain, then exit
        t.join()


def launch_report() -> str:
    """The stderr line that reports this process's kernel launches (only
    the kernels it launched)."""
    counts = {k: v for k, v in build.launch_counts.items() if v}
    return LAUNCH_MARK + json.dumps(counts, sort_keys=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch.hw twin server (op-stream driver protocol "
                    "v4, v3 fallback)")
    ap.add_argument("--socket", metavar="HOST:PORT", default=None,
                    help="serve over TCP instead of stdin/stdout "
                         "(PORT=0 picks an ephemeral port)")
    ap.add_argument("--max-conns", type=int, default=None,
                    help="serve at most N socket sessions concurrently "
                         "(default: unbounded)")
    ap.add_argument("--sessions", type=int, default=None,
                    help="exit after N socket sessions in all (default: "
                         "serve forever)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the twins (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch intra-op threads (default: torch's own)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.threads is not None:
        torch.set_num_threads(args.threads)
    try:
        if args.socket is not None:
            host, _, port = args.socket.rpartition(":")
            serve_socket(host or "127.0.0.1", int(port),
                         max_conns=args.max_conns, sessions=args.sessions,
                         device=device)
        else:
            # stdout is the wire: anything else must go to stderr
            serve(sys.stdin.buffer, sys.stdout.buffer, device)
    finally:
        print(launch_report(), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
