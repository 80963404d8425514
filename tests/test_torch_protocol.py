"""Port parity: the wire codec (``repro_torch.hw.protocol``) against the
reference's (``repro.hw.protocol``), and the port's device server driven
frame by frame in process.

* every dtype and shape round-trips both encodings bit for bit; torch
  tensors encode as their numpy values;
* for the same values a frame's bytes equal the reference's, in both
  encodings, and each package decodes the other's frames;
* oversized frames are refused before anything is written or buffered,
  malformed frames and out-of-bounds payload references are
  ``ProtocolError``s, and both encodings interleave on one stream;
* the server (``serve`` over byte buffers, ``--device cpu``) answers a
  malformed payload with an error frame and keeps the session, refuses
  v1/v2 clients and nested control ops, and executes a ``batch`` in
  order with per-op results.
"""

import io
import json

import numpy as np
import pytest
import torch

from repro.hw import protocol as jproto
from repro_torch.hw import protocol as tproto
from repro_torch.hw.protocol import (encode, decode, send, recv,
                                     ProtocolError, MAX_FRAME_BYTES)
from repro_torch.hw import server

ALL_DTYPES = ["float32", "float64", "int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64", "bool", "complex64",
              "complex128"]
SHAPES = [(), (0,), (5,), (2, 3), (2, 1, 4)]


def _array(name, shape, rng):
    dt = np.dtype(name)
    if dt.kind == "f":
        return rng.standard_normal(shape).astype(dt)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    if dt.kind == "b":
        return rng.integers(0, 2, shape).astype(dt)
    return rng.integers(0, 100, shape).astype(dt)


def _tree():
    rng = np.random.default_rng(0)
    tree = {f"{name}{i}": _array(name, shape, rng)
            for name in ALL_DTYPES for i, shape in enumerate(SHAPES)}
    tree["scalars"] = [1, 2.5, True, None, "s"]
    tree["nested"] = dict(x=[np.arange(4, dtype=np.float32).reshape(2, 2)])
    return tree


def _frame(proto, tree, binary):
    buf = io.BytesIO()
    proto.send(buf, dict(id=1, op="x", kw=proto.encode(tree, binary=binary)),
               binary=binary)
    return buf.getvalue()


@pytest.mark.parametrize("binary", [False, True])
def test_roundtrip_every_dtype_and_shape(binary):
    tree = _tree()
    out = decode(recv(io.BytesIO(_frame(tproto, tree, binary)))["kw"])
    for name, a in tree.items():
        if isinstance(a, np.ndarray):
            assert out[name].dtype == a.dtype, name
            assert out[name].shape == a.shape, name
            assert out[name].tobytes() == a.tobytes(), name
    assert out["scalars"] == [1, 2.5, True, None, "s"]
    np.testing.assert_array_equal(out["nested"]["x"][0],
                                  tree["nested"]["x"][0])


@pytest.mark.parametrize("binary", [False, True])
def test_frames_byte_equal_to_the_reference(binary):
    """The same values give the same frame bytes in both packages, and
    each decodes the other's frame; a tensor encodes as its numpy value."""
    tree = _tree()
    ours, theirs = _frame(tproto, tree, binary), _frame(jproto, tree, binary)
    assert ours == theirs
    got = jproto.decode(jproto.recv(io.BytesIO(ours))["kw"])
    assert all(got[k].tobytes() == v.tobytes() for k, v in tree.items()
               if isinstance(v, np.ndarray))
    tensors = {k: torch.from_numpy(v) for k, v in tree.items()
               if isinstance(v, np.ndarray) and v.dtype != np.uint16
               and v.dtype != np.uint32 and v.dtype != np.uint64}
    arrays = {k: tree[k] for k in tensors}
    assert _frame(tproto, tensors, binary) == _frame(jproto, arrays, binary)


def test_big_endian_arrays_are_normalized_to_wire_order():
    a = np.arange(5, dtype=">f8")
    for binary in (False, True):
        out = decode(recv(io.BytesIO(_frame(tproto, dict(a=a), binary)))
                     ["kw"])["a"]
        np.testing.assert_array_equal(out, a.astype("<f8"))


def test_binary_frame_is_raw_bytes_and_bounds_checked():
    arr = np.arange(4, dtype=np.float32)
    frame = bytearray(_frame(tproto, dict(a=arr), True))
    assert frame[:4] == b"\x00RB4" and arr.tobytes() in frame
    json_len = int(np.frombuffer(frame[4:8], "<u4")[0])
    head = json.loads(bytes(frame[12:12 + json_len]))
    assert head["kw"]["a"]["__nd__"] == [0, 16]
    head["kw"]["a"]["__nd__"] = [8, 64]          # past the 16-byte payload
    new_head = json.dumps(head, separators=(",", ":")).encode()
    rebuilt = (bytes(frame[:4])
               + np.asarray([len(new_head), 16], "<u4").tobytes()
               + new_head + arr.tobytes())
    with pytest.raises(ProtocolError, match="out of bounds"):
        recv(io.BytesIO(rebuilt))
    with pytest.raises(ProtocolError, match="bad magic"):
        recv(io.BytesIO(b"\x00RBX" + bytes(frame[4:])))


def test_malformed_and_oversized_frames_are_refused():
    with pytest.raises(ProtocolError, match="malformed"):
        recv(io.BytesIO(b"this is not json\n"))
    line = (json.dumps(dict(id=1, op="x", kw={"pad": "y" * 4096}))
            + "\n").encode()
    with pytest.raises(ProtocolError, match="oversized"):
        recv(io.BytesIO(line), max_bytes=1024)
    small = (json.dumps(dict(id=1, op="x")) + "\n").encode()
    assert recv(io.BytesIO(small), max_bytes=len(small))["op"] == "x"
    # multi-byte UTF-8 counts in bytes, not characters
    wide = (json.dumps(dict(pad="é" * 600), ensure_ascii=False)
            + "\n").encode()
    with pytest.raises(ProtocolError, match="oversized"):
        recv(io.BytesIO(wide), max_bytes=1000)
    big = np.zeros(MAX_FRAME_BYTES // 4 + 1024, np.float32)
    for binary in (False, True):
        buf = io.BytesIO()
        with pytest.raises(ProtocolError, match="oversized"):
            send(buf, dict(id=1, op="write_sigma",
                           kw=encode(dict(sigma=big), binary=binary)),
                 binary=binary)
        assert buf.getvalue() == b""             # nothing was written
    head = np.asarray([2, MAX_FRAME_BYTES], "<u4").tobytes()
    with pytest.raises(ProtocolError, match="oversized"):
        recv(io.BytesIO(b"\x00RB4" + head + b"{}"))


def test_encodings_interleave_on_one_stream():
    buf = io.BytesIO()
    send(buf, dict(id=1, op="a", kw=encode(dict(x=np.ones(2, np.float32)))))
    send(buf, dict(id=2, op="b", kw=encode(dict(x=torch.zeros(3)),
                                           binary=True)), binary=True)
    send(buf, dict(id=3, op="c", kw={}))
    buf.seek(0)
    assert recv(buf)["id"] == 1
    got = recv(buf)
    assert got["id"] == 2
    np.testing.assert_array_equal(decode(got["kw"])["x"],
                                  np.zeros(3, np.float32))
    assert recv(buf)["id"] == 3
    with pytest.raises(ProtocolError, match="closed"):
        recv(buf)


def _init(rid=1, v=4):
    return dict(id=rid, op="init", kw=dict(
        key=encode(np.asarray([0, 42], np.uint32)), n_blocks=4, k=3,
        kind="clements", m=6, n=6, v=v,
        model=dict(enabled=True, phase_bits=8, sigma_bits=None,
                   gamma_std=0.002, crosstalk=0.005, phase_bias=False),
        drift=None))


def _serve_script(*msgs, v4_after_init=False):
    """Run the port's server on a scripted byte stream of v3 frames (the
    init's reply is a JSON line; with a v4 init the rest comes back
    binary); returns the decoded replies."""
    fin = io.BytesIO()
    for m in msgs:
        send(fin, m)
    fin.seek(0)
    fout = io.BytesIO()
    server.serve(fin, fout, device="cpu")
    fout.seek(0)
    out = []
    while fout.tell() < len(fout.getvalue()):
        out.append(recv(fout))
    return out


def test_server_survives_malformed_payloads_and_refuses_old_clients():
    bad_nd = dict(id=1, op="init", kw={"key": {"__nd__": "!!!",
                                               "dtype": "float32",
                                               "shape": [1]}})
    resp = _serve_script(bad_nd, dict(id=5, op="forward", kw={}),
                         _init(rid=2, v=2), _init(rid=3, v=3))
    assert resp[0]["ok"] is False
    assert resp[1]["ok"] is False and "first op" in resp[1]["error"]
    assert resp[2]["ok"] is False and "protocol mismatch" in resp[2]["error"]
    assert resp[3]["ok"] is True and resp[3]["result"]["v"] == 3
    fin = io.BytesIO(b"5\n" + (json.dumps(_init(rid=2, v=3)) + "\n").encode())
    fout = io.BytesIO()
    server.serve(fin, fout, device="cpu")
    frames = [json.loads(ln) for ln in fout.getvalue().splitlines()]
    assert frames[0]["ok"] is False and frames[1]["ok"] is True


@pytest.mark.parametrize("nested", ["init", "shutdown", "batch", "meta",
                                    "unsafe/dev"])
def test_control_ops_cannot_nest_inside_batch(nested):
    resp = _serve_script(_init(v=3), dict(id=2, op="batch", kw=dict(
        ops=[dict(op="advance", kw=dict(dt=1.0)), dict(op=nested, kw={})])))
    assert resp[1]["ok"] is False
    assert "cannot appear inside a batch" in resp[1]["error"]


def test_batch_runs_in_order_and_names_a_failing_index():
    x = encode(np.ones((2, 3), np.float32))
    sig = encode(np.full((4, 3), 0.5, np.float32))
    resp = _serve_script(_init(v=3), dict(id=2, op="batch", kw=dict(ops=[
        dict(op="write_sigma", kw=dict(sigma=sig)),
        dict(op="read_sigma", kw={}),
        dict(op="forward", kw=dict(x=x)),
        dict(op="forward", kw=dict(x=x)),
        dict(op="stats", kw={})])), dict(id=3, op="batch", kw=dict(ops=[
            dict(op="advance", kw=dict(dt=1.0)),
            dict(op="charge", kw=dict(category="nope", calls=1.0))])),
        dict(id=4, op="read_sigma", kw={}))
    res = decode(resp[1]["result"])
    assert res[0] is None
    np.testing.assert_array_equal(res[1]["sigma"], np.full((4, 3), 0.5))
    assert res[2]["coalesced"] == 2 and res[2]["y"].shape == (2, 4, 2, 3)
    assert res[3]["probe"] == 16.0
    assert resp[2]["ok"] is False and "batch op 1" in resp[2]["error"]
    assert resp[3]["ok"] is True
