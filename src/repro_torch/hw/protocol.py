"""Op-stream wire protocol for out-of-process drivers (v4: binary framing).

Counterpart of ``repro/hw/protocol.py``; the normative spec is
``docs/wire-protocol.md``.  Frames travel over any byte stream (the
subprocess transport's stdin/stdout pipes, the socket transport's TCP
connection) in one of two encodings, told apart by the first byte:

* **JSON lines** (v3, and every ``init`` frame): one newline-terminated
  UTF-8 JSON document; arrays as base64 of their raw bytes plus dtype and
  shape.
* **Binary frames** (v4): ``b"\\x00RB4"``, u32 LE metadata length, u32 LE
  payload length, the JSON metadata (each array node replaced by
  ``{"__nd__": [offset, nbytes], "dtype": ..., "shape": ...}``), then the
  raw little-endian array payload.

Arrays cross this boundary as numpy on the host: a torch tensor is copied
to the host here (:func:`encode`), and :func:`decode` hands back numpy.
For the same values a frame's bytes equal the reference codec's in both
encodings, so the two packages' clients and servers can talk to each
other.  A frame over :data:`MAX_FRAME_BYTES` is refused before anything
is written (:func:`send`) or buffered (:func:`recv`); a malformed frame
is a :class:`ProtocolError`.

The ``batch`` frame (v3) carries an ordered op list executed in one
round trip; a run of coalescible ``forward`` ops may come back as one
``{"coalesced": n, "y": <(n, ...) array>}`` span.  Versions: the client
offers ``v`` in ``init`` (always a JSON line); a v4 server also speaks v3
(:data:`SUPPORTED_VERSIONS`) and echoes the negotiated version; a v4
client refused with "protocol mismatch" retries at v3 on the same
connection.  v1 and v2 peers are refused on both sides.
"""

from __future__ import annotations

import base64
import json
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

__all__ = ["encode", "decode", "send", "recv", "ProtocolError",
           "PROTOCOL_VERSION", "SUPPORTED_VERSIONS", "MAX_FRAME_BYTES"]

PROTOCOL_VERSION = 4

# versions a v4 server will negotiate down to in the init handshake
SUPPORTED_VERSIONS = (3, 4)

# Generous ceiling: the largest legitimate frames carry whole-chip phase
# banks / block targets.  64 MiB of frame ≈ a 16M-parameter write — far
# beyond any single-chip op here.
MAX_FRAME_BYTES = 64 * 1024 * 1024

_ND = "__nd__"

# binary frame header: magic (0x00 can never start a JSON text line),
# then u32 LE json-section length + u32 LE payload-section length
_MAGIC = b"\x00RB4"
_HEADER = struct.Struct("<II")


class ProtocolError(RuntimeError):
    """Framing / transport failure on the driver stream."""


def encode(obj: Any, binary: bool = False) -> Any:
    """Recursively wire-encode a python / numpy / torch value tree (a
    tensor is copied to the host first).

    With ``binary=False`` (the JSON-line codec) arrays become base64
    ``__nd__`` nodes.  With ``binary=True`` the ``__nd__`` value is the
    array's raw little-endian bytes — :func:`send` hoists those into the
    frame's payload section, zero base64.  :func:`decode` accepts both
    node forms, so a value encoded for one framing still decodes if it
    ends up inside the other (e.g. a pipelined op queued before the
    handshake settled the session codec).
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        return {k: encode(v, binary) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [encode(v, binary) for v in obj]
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    arr = np.asarray(obj)
    if arr.dtype.byteorder == ">":       # wire order is little-endian
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    raw = arr.tobytes()
    return {_ND: raw if binary else base64.b64encode(raw).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def decode(obj: Any) -> Any:
    """Inverse of :func:`encode` (arrays come back as numpy).

    ``__nd__`` payloads may be base64 strings (JSON-line frames) or raw
    bytes / memoryviews (binary frames, resolved by :func:`recv`).
    """
    if isinstance(obj, dict):
        if _ND in obj:
            raw = obj[_ND]
            if isinstance(raw, str):
                raw = base64.b64decode(raw)
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    return obj


def _hoist_payload(obj: Any, chunks: list, sizes: list) -> Any:
    """Rebuild ``obj`` with raw-bytes ``__nd__`` nodes replaced by
    ``[offset, nbytes]`` references into the payload section (the
    chunks are concatenated in reference order).  The input tree is
    never mutated — a pipelined frame may be re-encoded after an
    oversized split."""
    if isinstance(obj, dict):
        raw = obj.get(_ND)
        if isinstance(raw, (bytes, bytearray, memoryview)):
            off = sizes[0]
            chunks.append(raw)
            sizes[0] = off + len(raw)
            node = dict(obj)
            node[_ND] = [off, len(raw)]
            return node
        return {k: _hoist_payload(v, chunks, sizes) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_hoist_payload(v, chunks, sizes) for v in obj]
    return obj


def _resolve_payload(obj: Any, payload: memoryview) -> Any:
    """Inverse of :func:`_hoist_payload`: ``[offset, nbytes]`` node
    references become (zero-copy) memoryview slices of the payload."""
    if isinstance(obj, dict):
        ref = obj.get(_ND)
        if isinstance(ref, list) and len(ref) == 2:
            off, n = int(ref[0]), int(ref[1])
            if off < 0 or n < 0 or off + n > len(payload):
                raise ProtocolError(
                    f"binary frame payload reference [{off}, {n}] out of "
                    f"bounds for a {len(payload)}-byte payload section")
            node = dict(obj)
            node[_ND] = payload[off:off + n]
            return node
        return {k: _resolve_payload(v, payload) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve_payload(v, payload) for v in obj]
    return obj


def send(fp: BinaryIO, msg: dict, binary: bool = False) -> None:
    """Write one frame.  Size limits are enforced in encoded bytes and
    checked BEFORE anything is written — an oversized frame leaves the
    stream exactly as it was (callers rely on this to split op lists
    and to keep a session alive after refusing a too-large result)."""
    if binary:
        chunks: list = []
        sizes = [0]
        meta = _hoist_payload(msg, chunks, sizes)
        head = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        total = len(_MAGIC) + _HEADER.size + len(head) + sizes[0]
        if total > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"refusing to send oversized frame ({total} bytes > "
                f"{MAX_FRAME_BYTES})")
        fp.write(_MAGIC)
        fp.write(_HEADER.pack(len(head), sizes[0]))
        fp.write(head)
        for chunk in chunks:
            fp.write(chunk)
    else:
        data = (json.dumps(msg, separators=(",", ":")) + "\n").encode("utf-8")
        if len(data) > MAX_FRAME_BYTES:
            raise ProtocolError(
                f"refusing to send oversized frame ({len(data)} bytes > "
                f"{MAX_FRAME_BYTES})")
        fp.write(data)
    fp.flush()


def _read_exact(fp: BinaryIO, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = fp.read(n - len(buf))
        if not chunk:
            raise ProtocolError(
                "driver stream closed mid-frame (peer exited?)")
        buf.extend(chunk)
    return bytes(buf)


def recv(fp: BinaryIO, max_bytes: int = MAX_FRAME_BYTES) -> dict:
    """Read one frame, auto-detecting the encoding from its first byte
    (``0x00`` → binary, anything else → JSON line).  Bounded: neither
    path buffers more than ``max_bytes`` before rejecting."""
    first = fp.read(1)
    if not first:
        raise ProtocolError("driver stream closed (peer exited?)")
    if first == _MAGIC[:1]:
        magic = first + _read_exact(fp, len(_MAGIC) - 1)
        if magic != _MAGIC:
            raise ProtocolError(
                f"malformed binary frame: bad magic {magic!r}")
        json_len, payload_len = _HEADER.unpack(
            _read_exact(fp, _HEADER.size))
        total = len(_MAGIC) + _HEADER.size + json_len + payload_len
        if total > max_bytes:
            raise ProtocolError(
                f"oversized frame rejected (> {max_bytes} bytes)")
        head = _read_exact(fp, json_len)
        payload = memoryview(_read_exact(fp, payload_len))
        try:
            meta = json.loads(head)
        except json.JSONDecodeError as e:
            raise ProtocolError(
                f"malformed binary frame metadata: {head[:200]!r}") from e
        if not isinstance(meta, dict):
            raise ProtocolError(
                f"malformed frame: expected a dict, got {type(meta).__name__}")
        return _resolve_payload(meta, payload)
    # JSON line: bounded readline — a peer streaming an endless line
    # cannot make us buffer more than the frame ceiling (counted in
    # BYTES: multi-byte UTF-8 used to slip past a code-point count)
    line = first + fp.readline(max_bytes)
    if len(line) > max_bytes or (len(line) == max_bytes
                                 and not line.endswith(b"\n")):
        raise ProtocolError(
            f"oversized frame rejected (> {max_bytes} bytes)")
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"malformed frame: {line[:200]!r}") from e
    if not isinstance(msg, dict):
        # normalize here so both framings reject non-dict frames the
        # same way (serve() turns this into an error frame + live
        # session rather than a dropped connection)
        return {"__non_dict__": msg}
    return msg
