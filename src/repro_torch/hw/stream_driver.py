"""`StreamDriver`: shared op-stream client for out-of-process drivers.

Counterpart of ``repro/hw/stream_driver.py``.  Both wire transports,
:class:`~repro_torch.hw.subprocess_driver.SubprocessDriver` (frames over
stdin/stdout pipes) and :class:`~repro_torch.hw.socket_driver.SocketDriver`
(the same framing over TCP), are thin subclasses of this base, which owns
everything above the byte stream: the init version handshake (v4 with a
v3 fallback), per-op encode/decode, the ``batch`` frame, client-side write
pipelining and the async response reader.

* **Pipelined writes** (v3): ops with no observable result
  (:data:`PIPELINED_OPS`) queue client-side and flush, in order and in the
  same ``batch`` frame, ahead of the next op that reads anything; a tick
  that only advances clocks costs no round trip.
* **Explicit batching**: :meth:`run_batch` ships an ordered op list in one
  frame; a run of same-shape ``forward`` ops travels as one stacked
  ``forward_many`` entry and comes back as one stacked array.
* **Async issue / collect** (v4): :meth:`run_batch_async` writes the frame
  and returns a :class:`BatchFuture`; a daemon reader thread matches
  responses to futures by request id.  One session executes its frames in
  issue order, so async results equal the synchronous ones bit for bit.

Tensors become numpy at the wire (a device tensor is copied to the host)
and results come back as tensors on the driver's ``device``.  The in-situ
jobs travel with their per-step draws: a caller's generator is turned into
the draws the job would make from it (:func:`~repro_torch.hw.jobs.
job_draws`), so a job over the wire uses the bits it uses in process.
Each session counts its frames (``rpc_count``) and the bytes it wrote and
read (``wire_bytes``).
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np
import torch

from ..core import unitary as un
from ..core.noise import PhaseNoise
from ..device import resolve_device
from ..optim.zo import ZOConfig
from .device import DeviceRealization  # repro: noqa[RPL103]
from .driver import (PhotonicDriver, DriverStats, ZORefineResult, ICJobResult,
                     TwinUnavailable, resolve_block_range, BATCHABLE_OPS,
                     STAT_CATEGORIES, CompletedBatch, forward_coalesce_key,
                     coalesce_spans)
from .jobs import job_draws
from . import protocol
from .protocol import (encode, decode, send, recv, ProtocolError,
                       PROTOCOL_VERSION, SUPPORTED_VERSIONS)

__all__ = ["StreamDriver", "RemoteTwinHandle", "BatchFuture",
           "PIPELINED_OPS", "CountingStream"]


def _rng_kw(block_range):
    """Wire form of a block range (JSON list, or None for the whole chip)."""
    return None if block_range is None else [int(i) for i in block_range]


def _host(a, dtype=np.float32) -> np.ndarray:
    """``a`` as a host numpy array of ``dtype`` (a device tensor is copied)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


# ops with no observable result: safe to queue client-side and flush
# ahead of the next reading op (order is preserved server-side)
PIPELINED_OPS = frozenset([
    "write_phases", "write_sigma", "write_signs", "advance", "charge",
    "reset_stats",
])


class CountingStream:
    """A binary stream that counts the bytes read from or written to it
    (``n``); everything else passes through."""

    def __init__(self, fp):
        self._fp = fp
        self.n = 0

    def read(self, size=-1):
        data = self._fp.read(size)
        self.n += len(data)
        return data

    def readline(self, size=-1):
        data = self._fp.readline(size)
        self.n += len(data)
        return data

    def write(self, data):
        self.n += len(data)
        return self._fp.write(data)

    def flush(self):
        return self._fp.flush()

    def close(self):
        return self._fp.close()


class RemoteTwinHandle:
    """Remote twin readouts behind ``unsafe_twin()``: the peer's
    ``unsafe/*`` debug ops, which exist only because the peer is a
    simulator (a real-hardware daemon has none, and the driver raises
    :class:`TwinUnavailable`)."""

    def __init__(self, driver: "StreamDriver"):
        self._d = driver

    @property
    def dev(self) -> DeviceRealization:  # repro: noqa[RPL103]
        r = self._d._exec("unsafe/dev", {})
        t = self._d._tensor
        return DeviceRealization(  # repro: noqa[RPL103]
            noise_u=PhaseNoise(gamma=t(r["gamma_u"]), bias=t(r["bias_u"])),
            noise_v=PhaseNoise(gamma=t(r["gamma_v"]), bias=t(r["bias_v"])),
            d_u=t(r["d_u"]), d_v=t(r["d_v"]))

    def realized_unitaries(self) -> tuple[torch.Tensor, torch.Tensor]:
        r = self._d._exec("unsafe/realized_unitaries", {})
        return self._d._tensor(r["u"]), self._d._tensor(r["v"])

    def true_mapping_distance(self, w_blocks, block_range=None) -> float:
        r = self._d._exec("unsafe/true_mapping_distance",
                          dict(w_blocks=self._d._encode(_host(w_blocks)),
                               block_range=_rng_kw(block_range)))
        return float(r["d"])

    def bias_deviation(self) -> float:
        return float(self._d._exec("unsafe/bias_deviation", {})["d"])


class BatchFuture:
    """Handle to an in-flight :meth:`StreamDriver.run_batch_async` frame:
    ``result()`` blocks until the response arrives (optionally bounded by
    ``timeout`` seconds) and returns, or raises, exactly what
    :meth:`~StreamDriver.run_batch` would have."""

    def __init__(self, driver: "StreamDriver", names: list,
                 n_head: int, raw: Future):
        self._driver = driver
        self._names = names
        self._n_head = n_head
        self._raw = raw

    def done(self) -> bool:
        return self._raw.done()

    def result(self, timeout=None):
        resp = self._raw.result(timeout)
        return self._driver._finish_batch(self._names, self._n_head, resp)


class StreamDriver(PhotonicDriver):
    """Control-plane client over a framed op byte stream.

    Subclasses own the transport: they set ``self._fin`` / ``self._fout``
    (binary stream files), then call :meth:`_handshake`, and implement
    :meth:`_transport_alive`, :meth:`_transport_diagnostics` and
    :meth:`close`.
    """

    _fin = None
    _fout = None

    # -- transport hooks -----------------------------------------------------

    def _transport_alive(self) -> bool:
        """False once the peer is known dead or the driver closed."""
        return self._fout is not None

    def _transport_diagnostics(self) -> str:
        """Context appended to transport-failure errors (e.g. the server
        child's stderr tail)."""
        return ""

    # -- handshake -----------------------------------------------------------

    def _handshake(self, key, n_blocks: int, k: int, model, kind: str,
                   m, n, drift, protocol: int | None = None,
                   device=None) -> None:
        """Init the session, negotiating the wire protocol.

        ``key`` is the construction key (two uint32 words,
        :func:`~repro_torch.hw.driver.wire_key`).  Offers v4 by default; a
        v3-only peer answers with a ``protocol mismatch`` error frame and
        the client retries at v3 on the same connection.  ``protocol``
        pins a version (no fallback).  ``device`` is where results land."""
        self._device = resolve_device(device)
        self._cin = self._fin = CountingStream(self._fin)
        self._cout = self._fout = CountingStream(self._fout)
        self._rid = 0
        self._rpc_count = 0          # frames sent
        self._pending: list[dict] = []
        self._binary = False         # init always travels as a JSON line
        self._twin_verified = False
        self._lock = threading.Lock()
        self._inflight: dict[int, Future] = {}
        self._reader: threading.Thread | None = None
        self._reader_err: BaseException | None = None
        want = PROTOCOL_VERSION if protocol is None else int(protocol)
        if want not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"unsupported driver protocol v{want} "
                f"(client speaks {SUPPORTED_VERSIONS})")
        base = dict(
            key=encode(np.asarray(key, np.uint32)), n_blocks=int(n_blocks),
            k=int(k), kind=kind, m=m, n=n,
            model=dict(enabled=model.enabled, phase_bits=model.phase_bits,
                       sigma_bits=model.sigma_bits,
                       gamma_std=model.gamma_std, crosstalk=model.crosstalk,
                       phase_bias=model.phase_bias),
            drift=drift._asdict() if drift is not None else None)
        try:
            meta = self._exec("init", dict(base, v=want))
        except ProtocolError:
            self.close()
            raise
        except RuntimeError as e:
            if not (protocol is None and want > 3
                    and "protocol mismatch" in str(e)):
                self.close()
                raise
            # a v3-only peer refused the init with a clean error frame (the
            # stream is still framed): retry as a v3 session
            want = 3
            try:
                meta = self._exec("init", dict(base, v=want))
            except Exception:
                self.close()
                raise
        if int(meta.get("v", 1)) != want:
            self.close()
            raise ProtocolError(
                f"driver protocol mismatch: server negotiated "
                f"v{meta.get('v', 1)}, client asked for v{want}")
        self._binary = want >= 4     # everything after init goes binary
        self._protocol = want
        self._meta = meta

    # -- op stream -----------------------------------------------------------

    def _encode(self, obj):
        """Session-codec array encoding (binary once v4 is negotiated)."""
        return encode(obj, binary=getattr(self, "_binary", False))

    def _tensor(self, a) -> torch.Tensor:
        """A decoded wire array as a tensor on the driver's device (a
        tensor already there, as is)."""
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _ensure_reader(self) -> None:
        """Start the response reader (idempotent; the caller holds
        ``_lock``).  Until the first async op the driver is synchronous;
        from then on every response flows through the reader."""
        if self._reader is None:
            t = threading.Thread(target=self._read_loop, daemon=True,
                                 name=f"{type(self).__name__}-reader")
            self._reader = t
            t.start()

    def _read_loop(self) -> None:
        while True:
            try:
                resp = recv(self._fin)
            except Exception as e:
                with self._lock:
                    self._reader_err = e
                    inflight, self._inflight = self._inflight, {}
                err = ProtocolError(f"driver stream failed: {e}"
                                    + self._transport_diagnostics())
                for fut in inflight.values():
                    fut.set_exception(err)
                return
            with self._lock:
                fut = self._inflight.pop(resp.get("id"), None)
            if fut is not None:
                # unmatched ids (the id=0 shutdown ack) are dropped
                fut.set_result(resp)

    def _post(self, msg: dict) -> Future:
        """Write one request frame; return a future of the raw response.
        The future is registered before the frame is written, so a fast
        peer cannot race the reader.  Raises :class:`ProtocolError`
        without writing if the frame is oversized or the transport down."""
        fut: Future = Future()
        with self._lock:
            if not self._transport_alive():
                raise ProtocolError(
                    "driver stream is closed (peer exited or driver closed)"
                    + self._transport_diagnostics())
            if self._reader_err is not None:
                raise ProtocolError(
                    f"driver stream failed: {self._reader_err}"
                    + self._transport_diagnostics())
            self._ensure_reader()
            self._rid += 1
            rid = self._rid
            self._inflight[rid] = fut
            try:
                send(self._fout, dict(msg, id=rid), binary=self._binary)
                self._rpc_count += 1
            except Exception:
                del self._inflight[rid]
                raise
        return fut

    def _send_frame(self, msg: dict) -> dict:
        """One request frame → one decoded response (blocking)."""
        if not self._transport_alive():
            raise ProtocolError(
                "driver stream is closed (peer exited or driver closed)"
                + self._transport_diagnostics())
        try:
            if self._reader is not None:
                resp = self._post(msg).result()
            else:
                self._rid += 1
                send(self._fout, dict(msg, id=self._rid),
                     binary=self._binary)
                resp = recv(self._fin)
                self._rpc_count += 1
        except (ProtocolError, OSError) as e:
            raise ProtocolError(
                f"driver stream failed during op {msg.get('op')!r}: {e}"
                + self._transport_diagnostics()) from e
        if not resp.get("ok"):
            raise RuntimeError(f"remote driver op {msg.get('op')!r} failed:\n"
                               f"{resp.get('error')}")
        return decode(resp.get("result"))

    def _queue(self, op: str, kw: dict) -> None:
        """Pipeline a result-less op: no round trip until the next read."""
        self._pending.append(dict(op=op, kw=kw))

    def _result_bytes(self, entry: dict) -> int:
        """An upper estimate of the array bytes an entry's result carries
        (the reads, probes, readbacks and jobs; the writes carry none)."""
        op, kw = entry["op"], entry["kw"]
        br = kw.get("block_range")
        nb = self.n_blocks if br is None else int(br[1]) - int(br[0])
        k, t = self.k, un.mesh_spec(self.k, self.kind).n_rot

        def rows(name):
            shape = kw[name]["shape"]
            return int(np.prod(shape[:-1])) if len(shape) > 1 else 1

        if op == "forward":
            return 4 * nb * rows("x") * k
        if op == "forward_many":
            return 4 * nb * rows("xs") * k
        if op == "forward_layer":
            out = kw.get("out_dim") or self.layer_shape[0]
            return 4 * rows("x") * int(out)
        if op == "readback_bases":
            cols = kw.get("cols")
            return 8 * nb * k * (k if cols is None else len(cols))
        if op == "read_phases":
            return 8 * self.n_blocks * t
        if op == "read_sigma":
            return 4 * self.n_blocks * k
        if op in ("zo_refine", "run_ic"):
            return 4 * nb * (2 * t + 2 * k * k) + 4 * nb * kw["cfg"]["steps"]
        return 0

    def _send_ops(self, entries: list) -> list:
        """Per-op results for an entry list, in one ``batch`` frame where it
        fits.  A request over ``MAX_FRAME_BYTES`` is refused before
        anything is written, so the list is halved and sent again; a list
        whose results would overflow a frame is cut beforehand into runs
        whose results fit in half of one, and a single probe or readback
        that would overflow one is sent on block ranges
        (:meth:`_send_cut`).  The sequential encoding has the same
        semantics, so every cut gives the same bits."""
        room = protocol.MAX_FRAME_BYTES // 2
        if len(entries) == 1:
            e = entries[0]
            if e["op"] in ("forward", "readback_bases") and \
                    self._result_bytes(e) > room:
                return [self._send_cut(e, room)]
            return [self._send_frame(dict(op=e["op"], kw=e["kw"]))]
        runs, size = [[]], 0
        for e in entries:
            n = self._result_bytes(e)
            if runs[-1] and size + n > room:
                runs.append([])
                size = 0
            runs[-1].append(e)
            size += n
        if len(runs) > 1:
            self._send_split = True      # frame indices got renumbered
            return [r for run in runs for r in self._send_ops(run)]
        try:
            return self._send_frame(dict(op="batch", kw=dict(ops=entries)))
        except ProtocolError as e:
            if "refusing to send oversized frame" not in str(e):
                raise
            self._send_split = True
            mid = len(entries) // 2
            return self._send_ops(entries[:mid]) + self._send_ops(
                entries[mid:])

    def _send_cut(self, entry: dict, room: int) -> dict:
        """One ``forward`` or ``readback_bases`` whose result would overflow
        a frame (a whole-chip probe of a large chip), sent as the same op
        on consecutive block ranges whose results fit ``room``: the blocks
        are independent and lead the result, and the meter's charges add
        up to the one op's."""
        start, stop = resolve_block_range(self.n_blocks,
                                          entry["kw"].get("block_range"))
        per = max(1, room * (stop - start) // self._result_bytes(entry))
        parts = self._send_ops([
            dict(op=entry["op"], kw=dict(entry["kw"], block_range=[
                a, min(a + per, stop)])) for a in range(start, stop, per)])
        return {key: np.concatenate([r[key] for r in parts])
                for key in parts[0]}

    def _exec(self, op: str, kw: dict):
        """Issue an observable op, with any pipelined writes flushed ahead
        of it in the same ``batch`` frame.  Ops outside the batch set
        (``init``, ``unsafe/*``) flush first and travel alone."""
        if op not in BATCHABLE_OPS:
            self.flush()
            return self._send_frame(dict(op=op, kw=kw))
        ops, self._pending = self._pending, []
        ops.append(dict(op=op, kw=kw))
        return self._send_ops(ops)[-1]

    def flush(self) -> None:
        """Force any pipelined writes onto the device now."""
        if self._pending:
            ops, self._pending = self._pending, []
            self._send_ops(ops)

    # -- batched op lists ----------------------------------------------------

    def _validated_entries(self, ops) -> list:
        """Wire entries for an op list, consecutive coalescible ``forward``
        ops merged client-side into one stacked ``forward_many`` entry
        (the shared ``coalesce_spans`` rule, so the reply re-expands to the
        per-op results sequential dispatch returns)."""
        for name, _ in ops:
            if name not in BATCHABLE_OPS:
                raise ValueError(f"op {name!r} cannot appear inside a batch")
        first = ops[0] if ops else None
        if (len(ops) > 1 and all(o is first for o in ops)
                and first[0] == "forward"):
            keys = [forward_coalesce_key(first[1])] * len(ops)
        else:
            keys = [forward_coalesce_key(kw) if name == "forward" else None
                    for name, kw in ops]
        entries = []
        for i, j in coalesce_spans(keys):
            if j - i > 1:
                kw = ops[i][1]
                span = [k.get("x") for _, k in ops[i:j]]
                if all(s is span[0] for s in span):
                    x0 = _host(span[0])
                    xs = np.broadcast_to(x0, (len(span),) + x0.shape)
                else:
                    xs = np.stack([_host(s) for s in span])
                entries.append(dict(op="forward_many", kw=self._wire_kw(
                    "forward_many",
                    dict(xs=xs, category=kw.get("category", "probe"),
                         block_range=kw.get("block_range")))))
            else:
                name, kw = ops[i]
                entries.append(dict(op=name,
                                    kw=self._wire_kw(name, dict(kw))))
        return entries

    def _split_coalesced(self, raw: list) -> list:
        """A coalesced span comes back as one stacked array (op axis
        leading): moved to the device in one copy, then split into per-op
        results (views of it)."""
        flat: list = []
        for r in raw:
            if isinstance(r, dict) and "coalesced" in r:
                flat.extend(dict(y=y) for y in self._tensor(r["y"]))
            else:
                flat.append(r)
        return flat

    def run_batch(self, ops):
        """Execute ``[(op_name, kwargs), ...]`` in one round trip, pipelined
        writes flushed ahead in the same frame; the per-op results equal
        sequential execution bit for bit (the server meters each op)."""
        entries = self._validated_entries(ops)
        if not entries:
            return []
        head, self._pending = self._pending, []
        self._send_split = False
        try:
            raw = self._send_ops(head + entries)
        except RuntimeError as e:
            if head and not getattr(self, "_send_split", False):
                raise RuntimeError(
                    f"{e}\n(note: {len(head)} pipelined write(s) were "
                    f"flushed ahead of this run_batch in the same frame; "
                    f"server batch indices include them — subtract "
                    f"{len(head)} for this call's op list)") from e
            if head:
                raise RuntimeError(
                    f"{e}\n(note: {len(head)} pipelined write(s) were "
                    f"flushed with this run_batch and the frame was split "
                    f"for size — server batch indices are relative to a "
                    f"sub-frame, not this call's op list)") from e
            raise
        flat = self._split_coalesced(raw[len(head):])
        return [self._decode_result(name, r)
                for (name, _), r in zip(ops, flat)]

    def run_batch_async(self, ops):
        """Issue ``[(op_name, kwargs), ...]`` now and collect later: the
        frame (pipelined writes ahead of it) is written before this
        returns, and the :class:`BatchFuture`'s ``result()`` returns or
        raises what :meth:`run_batch` would have."""
        entries = self._validated_entries(ops)
        head, self._pending = self._pending, []
        all_entries = head + entries
        if not all_entries:
            return CompletedBatch([])
        names = [name for name, _ in ops]
        try:
            if sum(map(self._result_bytes, all_entries)) > \
                    protocol.MAX_FRAME_BYTES // 2:
                raise ProtocolError("refusing to send oversized frame: its "
                                    "results would overflow one")
            raw = self._post(dict(op="batch", kw=dict(ops=all_entries)))
        except ProtocolError as e:
            if "refusing to send oversized frame" not in str(e):
                raise
            # nothing was written: the synchronous cuts, resolved now
            self._send_split = True
            flat = self._split_coalesced(
                self._send_ops(all_entries)[len(head):])
            return CompletedBatch([self._decode_result(name, r)
                                   for name, r in zip(names, flat)])
        return BatchFuture(self, names, len(head), raw)

    def _finish_batch(self, names: list, n_head: int, resp: dict) -> list:
        """Decode a raw ``batch`` response frame for :class:`BatchFuture`."""
        if not resp.get("ok"):
            err = RuntimeError(
                f"remote driver op 'batch' failed:\n{resp.get('error')}")
            if n_head:
                raise RuntimeError(
                    f"{err}\n(note: {n_head} pipelined write(s) were "
                    f"flushed ahead of this run_batch_async in the same "
                    f"frame; server batch indices include them — subtract "
                    f"{n_head} for this call's op list)") from err
            raise err
        flat = self._split_coalesced(decode(resp.get("result"))[n_head:])
        return [self._decode_result(name, r)
                for name, r in zip(names, flat)]

    # -- per-op wire encoding / result decoding ------------------------------

    def _job_draws(self, gen, draws, method: str, b: int, steps: int,
                   restarts: int | None = None) -> np.ndarray:
        """A job's per-step draws for the wire: given, or made now from
        ``gen`` as the in-process job would make them (one stack per IC
        restart)."""
        if draws is None:
            if gen is None:
                raise ValueError("pass exactly one of gen= or draws=")
            draws = job_draws(gen, method, b, steps,
                              un.mesh_spec(self.k, self.kind).n_rot,
                              restarts)
        draws = _host(draws, None)
        # a coordinate draw is below 2^30: int32 halves the frame
        return draws.astype(np.int32) if method == "zcd" else draws

    def _wire_kw(self, op: str, kw: dict) -> dict:
        """Python kwargs → wire kwargs for ``op``, validated here so a
        pipelined op still fails at its call site."""
        nb = self.n_blocks
        if "block_range" in kw:
            br = kw["block_range"]
            if br is not None:
                start, stop = resolve_block_range(nb, br)
                nb = stop - start
            kw["block_range"] = _rng_kw(br)
        if op in ("write_phases", "write_sigma", "write_signs"):
            t = un.mesh_spec(self.k, self.kind).n_rot
            want = dict(phi_u=nb * t, phi_v=nb * t, sigma=nb * self.k,
                        d_u=nb * self.k, d_v=nb * self.k)
            for name, n_want in want.items():
                if name in kw and int(np.prod(np.shape(kw[name]))) != n_want:
                    raise ValueError(
                        f"{op}: {name} has "
                        f"{int(np.prod(np.shape(kw[name])))} elements, "
                        f"expected {n_want} for {nb} blocks of k={self.k}")
        if "category" in kw and kw["category"] not in STAT_CATEGORIES:
            raise ValueError(
                f"{op}: unknown PTC-meter category {kw['category']!r} "
                f"(one of {sorted(STAT_CATEGORIES)})")
        if op in ("write_phases", "write_sigma", "write_signs", "forward",
                  "forward_layer"):
            for name in ("phi_u", "phi_v", "sigma", "d_u", "d_v", "x"):
                if name in kw:
                    kw[name] = self._encode(_host(kw[name]))
        if op == "forward_many":
            kw["xs"] = self._encode(kw["xs"])
        if op == "forward_layer" and kw.get("out_dim") is not None:
            kw["out_dim"] = int(kw["out_dim"])
        if op == "readback_bases" and kw.get("cols") is not None:
            kw["cols"] = [int(c) for c in _host(kw["cols"], None)
                          .reshape(-1).tolist()]
        if op in ("zo_refine", "run_ic"):
            cfg = kw["cfg"]
            method = kw.get("method", "zcd")
            gen, draws = kw.pop("gen", None), kw.pop("draws", None)
            if op == "zo_refine":
                b = nb
                kw["w_blocks"] = self._encode(_host(kw["w_blocks"]))
                draws = self._job_draws(gen, draws, method, b, cfg.steps)
            else:
                kw["restarts"] = int(kw.get("restarts", 4))
                kw["sigs"] = self._encode(_host(kw["sigs"]))
                draws = self._job_draws(gen, draws, method, self.n_blocks,
                                        cfg.steps, kw["restarts"])
            kw["draws"] = self._encode(draws)
            kw["cfg"] = cfg._asdict()
        if op == "charge":
            kw["calls"] = float(kw["calls"])
        if op == "advance":
            kw["dt"] = float(kw["dt"])
        return kw

    def _decode_result(self, op: str, r):
        """A decoded wire result as the in-process driver returns it
        (tensors on the driver's device)."""
        t = self._tensor
        if op in PIPELINED_OPS:
            return None
        if op == "read_phases":
            return t(r["phi_u"]), t(r["phi_v"])
        if op == "read_sigma":
            return t(r["sigma"])
        if op in ("forward", "forward_layer"):
            return t(r["y"])
        if op == "readback_bases":
            return t(r["u"]), t(r["v"])
        if op == "zo_refine":
            return ZORefineResult(phi=t(r["phi"]), loss=t(r["loss"]),
                                  history=t(r["history"]),
                                  steps=int(r["steps"]))
        if op == "run_ic":
            return ICJobResult(phi=t(r["phi"]), u=t(r["u"]), v=t(r["v"]),
                               loss=t(r["loss"]), history=t(r["history"]))
        if op == "stats":
            return DriverStats(serve=r["serve"], probe=r["probe"],
                               readback=r["readback"], search=r["search"])
        return r

    # -- geometry ------------------------------------------------------------

    @property
    def k(self) -> int:
        return int(self._meta["k"])

    @property
    def kind(self) -> str:
        return str(self._meta["kind"])

    @property
    def n_blocks(self) -> int:
        return int(self._meta["n_blocks"])

    @property
    def layer_shape(self) -> tuple[int, int]:
        return int(self._meta["m"]), int(self._meta["n"])

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def protocol(self) -> int:
        """The wire protocol version this session negotiated (3 or 4)."""
        return int(getattr(self, "_protocol", PROTOCOL_VERSION))

    @property
    def rpc_count(self) -> int:
        """Request frames this session has sent (the init included)."""
        return self._rpc_count

    @property
    def wire_bytes(self) -> tuple[int, int]:
        """(bytes written, bytes read) on this session's stream."""
        return self._cout.n, self._cin.n

    # -- commanded state (pipelined: no round trip) --------------------------

    def write_phases(self, phi_u, phi_v, *, block_range=None) -> None:
        self._queue("write_phases", self._wire_kw(
            "write_phases", dict(phi_u=phi_u, phi_v=phi_v,
                                 block_range=block_range)))

    def write_sigma(self, sigma, *, block_range=None) -> None:
        self._queue("write_sigma", self._wire_kw(
            "write_sigma", dict(sigma=sigma, block_range=block_range)))

    def write_signs(self, d_u, d_v, *, block_range=None) -> None:
        self._queue("write_signs", self._wire_kw(
            "write_signs", dict(d_u=d_u, d_v=d_v, block_range=block_range)))

    def read_phases(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._decode_result("read_phases",
                                   self._exec("read_phases", {}))

    def read_sigma(self) -> torch.Tensor:
        return self._decode_result("read_sigma", self._exec("read_sigma", {}))

    # -- probes --------------------------------------------------------------

    def forward(self, x, category: str = "probe", *,
                block_range=None) -> torch.Tensor:
        kw = self._wire_kw("forward", dict(x=x, category=category,
                                           block_range=block_range))
        return self._decode_result("forward", self._exec("forward", kw))

    def forward_layer(self, x, *, block_range=None,
                      out_dim: int | None = None) -> torch.Tensor:
        kw = self._wire_kw("forward_layer", dict(x=x, block_range=block_range,
                                                 out_dim=out_dim))
        return self._decode_result("forward_layer",
                                   self._exec("forward_layer", kw))

    def readback_bases(self, cols=None, *,
                       block_range=None) -> tuple[torch.Tensor, torch.Tensor]:
        kw = self._wire_kw("readback_bases", dict(cols=cols,
                                                  block_range=block_range))
        return self._decode_result("readback_bases",
                                   self._exec("readback_bases", kw))

    # -- in-situ jobs --------------------------------------------------------

    def zo_refine(self, w_blocks, gen, cfg: ZOConfig, method: str = "zcd", *,
                  block_range=None, draws=None) -> ZORefineResult:
        kw = self._wire_kw("zo_refine", dict(
            w_blocks=w_blocks, gen=gen, cfg=cfg, method=method,
            block_range=block_range, draws=draws))
        return self._decode_result("zo_refine", self._exec("zo_refine", kw))

    def run_ic(self, gen, sigs, cfg: ZOConfig, *, restarts: int = 4,
               method: str = "zcd", draws=None) -> ICJobResult:
        kw = self._wire_kw("run_ic", dict(gen=gen, sigs=sigs, cfg=cfg,
                                          restarts=restarts, method=method,
                                          draws=draws))
        return self._decode_result("run_ic", self._exec("run_ic", kw))

    # -- time / accounting / escape hatch ------------------------------------

    def advance(self, dt: float = 1.0) -> None:
        self._queue("advance", self._wire_kw("advance", dict(dt=dt)))

    @property
    def stats(self) -> DriverStats:
        return self._decode_result("stats", self._exec("stats", {}))

    def reset_stats(self) -> None:
        self._queue("reset_stats", {})

    def charge(self, category: str, calls: float) -> None:
        self._queue("charge", self._wire_kw(
            "charge", dict(category=category, calls=calls)))

    def unsafe_twin(self) -> RemoteTwinHandle:
        # a dead stream means no twin, not a ProtocolError deep in a handle
        if not self._transport_alive():
            raise TwinUnavailable(
                "driver stream is closed (peer exited or driver closed)")
        # probe the peer's unsafe/* support once per live stream
        if not getattr(self, "_twin_verified", False):
            try:
                self._exec("unsafe/bias_deviation", {})
            except RuntimeError as e:
                raise TwinUnavailable(str(e)) from e
            self._twin_verified = True
        return RemoteTwinHandle(self)

    # -- lifecycle -----------------------------------------------------------

    def _shutdown_stream(self) -> None:
        """Best-effort goodbye: send the shutdown frame and return, without
        a flush or an ack wait (pending pipelined writes are dropped: only
        reads that will never happen could observe them).  Errors are
        swallowed, so close() succeeds on a dead peer."""
        self._twin_verified = False
        try:
            self._pending = []
            send(self._fout, dict(id=0, op="shutdown", kw={}),
                 binary=getattr(self, "_binary", False))
        except Exception:
            pass
