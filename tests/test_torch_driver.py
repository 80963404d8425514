"""Port conformance: the driver plane's three transports.

``repro_torch.hw.make_driver`` over ``twin`` (in process), ``subprocess``
(a ``repro_torch.hw.server`` child over pipes) and ``socket`` (a session on
one ``--socket`` server started for this module; the self-hosted loopback
child is exercised too), all on the CPU with one torch thread:

* a scripted session of every ABC op, a tenant-scoped session and the IC /
  PM / recalibration flows give the in-process twin's results bit for bit
  from one generator, with equal meters, on every transport; the stream
  transports pinned to wire v3 give the v4 bits; ``run_batch_async`` ≡
  ``run_batch``; batched ops are metered one by one;
* the stream client: pipelined writes flush ahead of a read in one frame,
  validate at their call site and split an oversized aggregate frame; the
  ``unsafe_twin`` readouts equal the twin's; a v3-only server is reached
  through the fallback; concurrent sessions share one server; a child
  that dies before announcing its port fails construction without leaks;
* ``ReferenceInstrumentDriver`` with hooks that call a twin passes the
  scripted session with the twin's results and meter, and has no twin.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.calibration import calibrate_identity
from repro_torch.core.mapping import parallel_map
from repro_torch.core.noise import DEFAULT_NOISE
from repro_torch.hw import (make_driver, DriftConfig, TwinUnavailable,
                            ReferenceInstrumentDriver, wire_key,
                            key_generator, make_twin)
from repro_torch.hw import protocol as tproto
from repro_torch.hw import server as tserver
from repro_torch.hw.socket_driver import SocketDriver
from repro_torch.hw.subprocess_driver import server_env
from repro_torch.optim.zo import ZOConfig
from repro_torch.runtime.recalibrate import RecalConfig, recalibrate

K = 3
M = N = 6
B = (M // K) * (N // K)          # 4 blocks
MODEL = DEFAULT_NOISE.post_ic()
DRIFT = DriftConfig(sigma_phase=0.03, theta=0.01)
SEED = 42
TRANSPORTS = ["twin", "subprocess", "socket"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here and in every server child (the children
    take the parent's count), as the suite's other port files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def daemon(_one_torch_thread):
    """One ``--socket`` server for the module: every socket session here
    is a connection to it."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.hw.server", "--socket",
         "127.0.0.1:0", "--device", "cpu", "--threads", "1"],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=server_env())
    try:
        line = proc.stdout.readline().decode()
        assert line.startswith("LISTENING "), line
        yield ("127.0.0.1", int(line.split()[1]))
    finally:
        proc.kill()
        proc.wait(timeout=30)


def _gen(seed=SEED):
    return torch.Generator().manual_seed(seed)


def _mk(transport, daemon, protocol=None, seed=SEED):
    address = daemon if transport == "socket" else None
    return make_driver(transport, _gen(seed), B, K, MODEL, m=M, n=N,
                       drift=DRIFT, device="cpu", address=address,
                       protocol=protocol)


def _f32(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


def _session(driver, with_twin=True) -> dict:
    """A scripted control-plane session over every ABC op."""
    rng = np.random.default_rng(7)
    t = driver.read_phases()[0].shape[-1]
    x = _f32(rng.standard_normal((5, K)))
    w = _f32(rng.standard_normal((B, K, K)) * 0.4)
    out = {}
    driver.write_signs(_f32(rng.choice([-1.0, 1.0], (B, K))),
                       _f32(rng.choice([-1.0, 1.0], (B, K))))
    driver.write_phases(_f32(rng.uniform(0, 1, (B, t))),
                        _f32(rng.uniform(0, 1, (B, t))))
    driver.write_sigma(_f32(rng.uniform(0.5, 1.5, (B, K))))
    out["phi_u"], out["phi_v"] = driver.read_phases()
    out["sigma"] = driver.read_sigma()
    out["fwd"] = driver.forward(x)
    out["layer"] = driver.forward_layer(_f32(rng.standard_normal((3, N))))
    res = driver.zo_refine(w, _gen(3), ZOConfig(steps=30, inner=12,
                                                delta0=0.1, decay=1.05))
    out["zo_phi"], out["zo_loss"], out["zo_hist"] = \
        res.phi, res.loss, res.history
    out["u"], out["v"] = driver.readback_bases()
    out["u_cols"], _ = driver.readback_bases(cols=[0, 2])
    for _ in range(5):
        driver.advance(1.0)
    out["fwd_drifted"] = driver.forward(x)
    ops = [("forward", dict(x=x)), ("forward", dict(x=x)),
           ("read_sigma", {}), ("forward_layer", dict(x=x[:2].repeat(1, 2)))]
    out["batch"] = driver.run_batch(ops)
    fut = driver.run_batch_async(ops)
    out["async"] = fut.result()
    driver.charge("probe", 2.5)
    if with_twin:
        out["true_d"] = driver.unsafe_twin().true_mapping_distance(w)
    out["stats"] = driver.stats.as_dict()
    return out


def _assert_same(want: dict, got: dict) -> None:
    assert want.keys() == got.keys()
    for name, a in want.items():
        b = got[name]
        if isinstance(a, list):
            assert len(a) == len(b), name
            for i, (x, y) in enumerate(zip(a, b)):
                assert torch.equal(x, y), (name, i)
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


_REF: dict = {}


def _twin_result(name, fn):
    if name not in _REF:
        d = make_driver("twin", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                        device="cpu")
        _REF[name] = fn(d)
    return _REF[name]


@pytest.mark.parametrize("transport,protocol", [
    ("twin", None), ("subprocess", None), ("subprocess", 3),
    ("socket", None), ("socket", 3)])
def test_scripted_session_matches_the_twin(transport, protocol, daemon):
    """Every op's result and the meter equal the in-process twin's from the
    same generator; a pinned v3 session gives the v4 bits."""
    driver = _mk(transport, daemon, protocol)
    try:
        if transport != "twin":
            assert driver.protocol == (protocol or 4)
        got = _session(driver)
    finally:
        driver.close()
    _assert_same(_twin_result("scripted", _session), got)
    assert torch.equal(got["async"][0], got["batch"][0])


def _tenant_session(driver) -> dict:
    """Two tenants, blocks [0, 3) and [3, 4), through every block-range
    scoped op."""
    rng = np.random.default_rng(11)
    t = driver.read_phases()[0].shape[-1]
    br0, br1, b0, b1 = (0, 3), (3, B), 3, B - 3
    out = {}
    driver.write_signs(_f32(rng.choice([-1.0, 1.0], (b0, K))),
                       _f32(rng.choice([-1.0, 1.0], (b0, K))),
                       block_range=br0)
    driver.write_phases(_f32(rng.uniform(0, 1, (b0, t))),
                        _f32(rng.uniform(0, 1, (b0, t))), block_range=br0)
    driver.write_sigma(_f32(rng.uniform(0.5, 1.5, (b0, K))),
                       block_range=br0)
    driver.write_phases(_f32(rng.uniform(0, 1, (b1, t))),
                        _f32(rng.uniform(0, 1, (b1, t))), block_range=br1)
    driver.write_sigma(_f32(rng.uniform(0.5, 1.5, (b1, K))),
                       block_range=br1)
    out["phi_u"], out["phi_v"] = driver.read_phases()
    out["sigma"] = driver.read_sigma()
    x = _f32(rng.standard_normal((4, K)))
    out["fwd0"] = driver.forward(x, block_range=br0)
    out["fwd1"] = driver.forward(x, block_range=br1)
    out["layer1"] = driver.forward_layer(_f32(rng.standard_normal((2, K))),
                                         block_range=br1, out_dim=K)
    w0 = _f32(rng.standard_normal((b0, K, K)) * 0.4)
    res = driver.zo_refine(w0, _gen(5), ZOConfig(steps=20, inner=12),
                           block_range=br0)
    out["zo_phi"] = res.phi
    out["u1"], out["v1"] = driver.readback_bases(block_range=br1)
    out["u0_cols"], _ = driver.readback_bases(cols=[0, 2], block_range=br0)
    for _ in range(4):
        driver.advance(1.0)
    out["fwd0_drifted"] = driver.forward(x, block_range=br0)
    out["probe_sweep"] = driver.run_batch(
        [("forward", dict(x=x, block_range=br0))] * 3)
    out["true0"] = driver.unsafe_twin().true_mapping_distance(w0, br0)
    out["stats"] = driver.stats.as_dict()
    return out


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_tenant_session_matches_the_twin(transport, daemon):
    driver = _mk(transport, daemon)
    try:
        got = _tenant_session(driver)
    finally:
        driver.close()
    _assert_same(_twin_result("tenant", _tenant_session), got)


def _flows(driver) -> dict:
    """IC, then PM, 30 drifting ticks and a recalibration on one chip."""
    ic = calibrate_identity(_gen(1), B, K, MODEL, restarts=2, driver=driver,
                            cfg=ZOConfig(steps=40, inner=12, delta0=0.5))
    rng = np.random.default_rng(5)
    w = _f32(rng.standard_normal((M, N)) / np.sqrt(M))
    pm = parallel_map(_gen(2), w, K, MODEL, driver=driver,
                      cfg=ZOConfig(steps=30, inner=12, delta0=0.2))
    for _ in range(30):
        driver.advance(1.0)
    blocks = _f32(rng.standard_normal((B, K, K)) * 0.4)
    rc = recalibrate(_gen(9), driver, blocks,
                     RecalConfig(zo_steps=40, delta0=0.05))
    return dict(ic_phi_u=ic.phi_u, ic_mse_u=ic.mse_u, ic_hist=ic.history,
                pm_err_osp=pm.err_osp, pm_phi_u=pm.phi_u, rc_phi=rc.phi,
                rc_sigma=rc.sigma, rc_dist=float(rc.dist_after),
                rc_calls=rc.ptc_calls, stats=driver.stats.as_dict())


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_ic_pm_recal_identical_across_transports(transport, daemon):
    driver = _mk(transport, daemon)
    try:
        got = _flows(driver)
    finally:
        driver.close()
    _assert_same(_twin_result("flows", _flows), got)


def test_writes_pipeline_validate_and_split(daemon, monkeypatch):
    """Result-less ops send nothing until a read, which carries them in
    one frame; a bad write raises at its call site; an aggregate over the
    frame limit is halved, never refused."""
    driver = _mk("socket", daemon)
    try:
        rng = np.random.default_rng(1)
        t = driver.read_phases()[0].shape[-1]
        pu, pv = _f32(rng.uniform(0, 1, (B, t))), _f32(rng.uniform(0, 1, (B, t)))
        frames0 = driver.rpc_count
        driver.write_phases(pu, pv)
        driver.advance(1.0)
        driver.charge("probe", 2.5)
        assert driver.rpc_count == frames0
        ru, _ = driver.read_phases()
        assert driver.rpc_count == frames0 + 1 and torch.equal(ru, pu)
        assert driver.stats.probe == 2.5
        with pytest.raises(ValueError):
            driver.write_sigma(torch.ones((2, K)), block_range=(0, B + 1))
        with pytest.raises(ValueError, match="elements"):
            driver.write_sigma(torch.ones((B, K + 1)))
        with pytest.raises(ValueError, match="category"):
            driver.charge("nope", 1.0)
        with pytest.raises(ValueError, match="cannot appear"):
            driver.run_batch([("close", {})])
        monkeypatch.setattr(tproto, "MAX_FRAME_BYTES", 1200)
        frames0 = driver.rpc_count
        for _ in range(6):
            driver.write_phases(pv, pu)
        ru, _ = driver.read_phases()
        assert driver.rpc_count - frames0 > 1 and torch.equal(ru, pv)
        monkeypatch.undo()
        driver.advance(1.0)
        with pytest.raises(RuntimeError, match="pipelined write"):
            driver.run_batch([("charge", dict(category="probe", calls=1.0)),
                              ("zo_refine", dict(w_blocks=torch.ones(1),
                                                 gen=_gen(), cfg=ZOConfig(
                                                     steps=2)))])
    finally:
        driver.close()
    with pytest.raises(TwinUnavailable):
        driver.unsafe_twin()


def test_unsafe_readouts_and_async_order_match_the_twin(daemon, monkeypatch):
    """The remote realization, realized bases and bias deviation equal the
    in-process twin's; async frames collected out of order give the
    synchronous results; a batch whose results would overflow a frame is
    cut into several, with the same results."""
    twin = make_driver("twin", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                       device="cpu")
    driver = _mk("socket", daemon)
    try:
        for d in (twin, driver):
            d.advance(3.0)
        h, th = driver.unsafe_twin(), twin.unsafe_twin()
        for a, b in zip(h.dev, th.dev):
            for x, y in zip(*(v if isinstance(v, tuple) else (v,)
                              for v in (a, b))):
                assert torch.equal(x, y)
        for x, y in zip(h.realized_unitaries(), th.realized_unitaries()):
            assert torch.equal(x, y)
        assert h.bias_deviation() == th.bias_deviation()
        xs = [_f32(np.full((2, K), i + 1.0)) for i in range(3)]
        futs = [driver.run_batch_async([("forward", dict(x=x))]) for x in xs]
        got = [f.result()[0] for f in reversed(futs)][::-1]
        for x, y in zip(xs, got):
            assert torch.equal(twin.forward(x), y)
        ops = [("readback_bases", {})] * 16
        monkeypatch.setattr(tproto, "MAX_FRAME_BYTES", 4000)
        frames0 = driver.rpc_count
        got = driver.run_batch(ops) + driver.run_batch_async(ops).result()
        assert driver.rpc_count - frames0 >= 4
        for (u, v), (tu, tv) in zip(got, twin.run_batch(ops + ops)):
            assert torch.equal(u, tu) and torch.equal(v, tv)
        # one probe whose result overflows a frame goes out on block ranges
        x = torch.randn((40, K), generator=_gen(2))
        monkeypatch.setattr(tproto, "MAX_FRAME_BYTES", 2000)
        frames0 = driver.rpc_count
        got = [driver.forward(x), driver.run_batch_async(
            [("forward", dict(x=x)), ("readback_bases", {})]).result()[0],
            driver.readback_bases()]
        assert driver.rpc_count - frames0 >= 4
        monkeypatch.undo()
        assert torch.equal(got[0], twin.forward(x))
        assert torch.equal(got[1], twin.forward(x))
        twin.readback_bases()
        for a, b in zip(got[2], twin.readback_bases()):
            assert torch.equal(a, b)
        assert driver.stats.as_dict() == twin.stats.as_dict()
    finally:
        driver.close()


def test_v3_only_server_is_reached_through_the_fallback(monkeypatch):
    """A v4 client refused by a v3-only server retries at v3 on the same
    connection; a client pinned to v4 sees the mismatch."""
    monkeypatch.setattr(tserver, "SUPPORTED_VERSIONS", (3,))
    ann = _Announce()
    t = threading.Thread(target=tserver.serve_socket, args=("127.0.0.1", 0),
                         kwargs=dict(sessions=2, announce=ann, device="cpu"),
                         daemon=True)
    t.start()
    assert ann.ready.wait(timeout=30)
    addr = ("127.0.0.1", ann.port)
    twin = make_driver("twin", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                       device="cpu")
    d = make_driver("socket", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                    device="cpu", address=addr)
    try:
        assert d.protocol == 3
        x = torch.ones((2, K))
        assert torch.equal(d.forward(x), twin.forward(x))
    finally:
        d.close()
    with pytest.raises(RuntimeError, match="protocol mismatch"):
        make_driver("socket", _gen(), B, K, MODEL, m=M, n=N, device="cpu",
                    address=addr, protocol=4)
    t.join(timeout=30)
    assert not t.is_alive()


class _Announce:
    """Captures ``serve_socket``'s ``LISTENING <port>`` line."""

    def __init__(self):
        self.port = None
        self.ready = threading.Event()

    def write(self, s):
        if s.startswith("LISTENING"):
            self.port = int(s.split()[1])
            self.ready.set()

    def flush(self):
        pass


def test_concurrent_sessions_and_a_poisoned_one_share_a_server(daemon):
    """Three sessions at once on one server each give the twin's bits; a
    client that sends garbage gets an error frame and the server goes on
    serving."""
    with socket.create_connection(daemon) as raw:
        raw.sendall(b"not a frame\n")
        assert b"protocol error" in raw.makefile("rb").readline()
    key = wire_key(_gen())
    x = torch.randn((4, K), generator=_gen(1))
    want = make_twin(key_generator(key), B, K, MODEL, m=M, n=N, drift=DRIFT,
                     device="cpu").forward(x)
    oks, errs = [False] * 3, []
    barrier = threading.Barrier(3)

    def worker(i):
        try:
            d = SocketDriver(key, B, K, MODEL, m=M, n=N, drift=DRIFT,
                             address=daemon, device="cpu")
            try:
                barrier.wait()
                ys = d.run_batch([("forward", dict(x=x))] * 4)
                oks[i] = all(torch.equal(y, want) for y in ys)
            finally:
                d.close()
        except Exception as e:  # noqa: BLE001 - raised below
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and all(oks)


def test_self_hosted_socket_child_and_its_failures(tmp_path):
    """Without ``address`` the socket driver spawns its own loopback
    server; a child that dies before announcing its port fails
    construction fast, without leaking the child or its stderr spool."""
    d = make_driver("socket", _gen(), B, K, MODEL, m=M, n=N, device="cpu")
    try:
        assert d.protocol == 4 and d.forward(torch.ones((2, K))).shape == \
            (B, 2, K)
        spool = d._stderr.name
    finally:
        d.close()
    assert d.server_launches == {} and not os.path.exists(spool)
    fake = tmp_path / "fake-python"
    fake.write_text("#!/bin/sh\necho oops >&2\nexit 1\n")
    fake.chmod(0o755)
    with pytest.raises(tproto.ProtocolError, match="exited before"):
        SocketDriver(wire_key(_gen()), B, K, MODEL, python=str(fake),
                     device="cpu", connect_timeout=10.0)


class TwinBackedInstrument(ReferenceInstrumentDriver):
    """The instrument skeleton with its light-touching hooks wired to a
    twin (what a lab integrator wires to DACs and detectors)."""

    def __init__(self, twin):
        super().__init__(twin.n_blocks, twin.k, twin.kind, m=M, n=N,
                         device="cpu")
        self._twin = twin

    def _hw_apply_phases(self, phi_u, phi_v, start, stop):
        self._twin.write_phases(phi_u, phi_v, block_range=(start, stop))

    def _hw_apply_sigma(self, sigma, start, stop):
        self._twin.write_sigma(sigma, block_range=(start, stop))

    def _hw_apply_signs(self, d_u, d_v, start, stop):
        self._twin.write_signs(d_u, d_v, block_range=(start, stop))

    def _hw_forward(self, x, start, stop):
        return self._twin.forward(x, block_range=(start, stop))

    def _hw_forward_layer(self, x, start, stop, out_dim):
        return self._twin.forward_layer(x, block_range=(start, stop),
                                        out_dim=out_dim)

    def _hw_readback(self, cols, start, stop):
        return self._twin.readback_bases(cols, block_range=(start, stop))

    def _hw_zo_refine(self, w_blocks, draws, cfg, method, start, stop):
        r = self._twin.zo_refine(w_blocks, None, cfg, method,
                                 block_range=(start, stop), draws=draws)
        return r.phi, r.loss, r.history

    def _hw_run_ic(self, draws, sigs, cfg, restarts, method):
        r = self._twin.run_ic(None, sigs, cfg, restarts=restarts,
                              method=method, draws=draws)
        return r.phi, r.u, r.v, r.loss, r.history

    def advance(self, dt=1.0):
        super().advance(dt)
        self._twin.advance(dt)      # the physical chip drifts on its own


def test_instrument_skeleton_passes_the_scripted_session():
    twin = make_driver("twin", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                       device="cpu")
    inst = TwinBackedInstrument(twin)
    got = _session(inst, with_twin=False)
    want = dict(_twin_result("scripted", _session))
    want.pop("true_d")
    _assert_same(want, got)
    assert inst.clock == 5.0
    with pytest.raises(TwinUnavailable):
        inst.unsafe_twin()
    # IC on the same chip state: the skeleton hands the job its draws
    twin2 = make_driver("twin", _gen(), B, K, MODEL, m=M, n=N, drift=DRIFT,
                        device="cpu")
    _session(twin2, with_twin=False)
    ics = [calibrate_identity(_gen(1), B, K, MODEL, restarts=2, driver=d,
                              cfg=ZOConfig(steps=10, inner=5, delta0=0.5))
           for d in (inst, twin2)]
    for a, b in zip(*ics):
        assert torch.equal(a, b)
    assert inst.stats.as_dict() == twin2.stats.as_dict()
