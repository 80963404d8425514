"""Interop: the port's and the reference's driver planes speak one wire.

* the port's ``SocketDriver`` against ``python -m repro.hw.server --socket``
  (a child with x64 off), and the reference's ``SocketDriver`` against
  ``python -m repro_torch.hw.server --socket --device cpu``;
* the two packages draw different realizations from one key, so each
  session reads the remote realization through ``unsafe/dev`` and builds
  its own package's in-process twin from it (``make_twin(..., dev=)``);
  every result is held against that twin at 1e-5 (as
  ``tests/test_torch_twin.py``), commanded state and the meter exactly;
* version negotiation across packages: v4 by default, a pinned v3, and a
  v4 client falling back to a v3-only server of the other package.
"""

import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noise import DEFAULT_NOISE as J_NOISE
from repro.hw import make_twin as j_make_twin
from repro.hw import server as jserver
from repro.hw.socket_driver import SocketDriver as JSocketDriver
from repro_torch import convert
from repro_torch.hw import make_twin, wire_key
from repro_torch.hw import server as tserver
from repro_torch.hw.socket_driver import SocketDriver
from repro_torch.hw.subprocess_driver import server_env
from repro_torch.optim.zo import ZOConfig

K = 3
M = N = 6
B = (M // K) * (N // K)
J_MODEL = J_NOISE.post_ic()
MODEL = convert.noise_model(J_MODEL)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _daemon(module, extra_env=None):
    env = server_env()
    env.update(extra_env or {})
    args = [sys.executable, "-u", "-m", module, "--socket", "127.0.0.1:0"]
    if module.startswith("repro_torch"):
        args += ["--device", "cpu", "--threads", "1"]
    proc = subprocess.Popen(args, stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, env=env)
    line = proc.stdout.readline().decode()
    assert line.startswith("LISTENING "), line
    return proc, ("127.0.0.1", int(line.split()[1]))


@pytest.fixture(scope="module")
def ref_server():
    proc, addr = _daemon("repro.hw.server",
                         dict(JAX_ENABLE_X64="0", JAX_PLATFORMS="cpu"))
    yield addr
    proc.kill()
    proc.wait(timeout=30)


@pytest.fixture(scope="module")
def port_server():
    proc, addr = _daemon("repro_torch.hw.server")
    yield addr
    proc.kill()
    proc.wait(timeout=30)


def _inputs():
    rng = np.random.default_rng(7)
    t = K * (K - 1) // 2
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(d_u=f(rng.choice([-1.0, 1.0], (B, K))),
                d_v=f(rng.choice([-1.0, 1.0], (B, K))),
                phi_u=f(rng.uniform(0, 1, (B, t))),
                phi_v=f(rng.uniform(0, 1, (B, t))),
                sigma=f(rng.uniform(0.5, 1.5, (B, K))),
                x=f(rng.standard_normal((5, K))),
                xl=f(rng.standard_normal((3, N))),
                w=f(rng.standard_normal((B, K, K)) * 0.4))


def _session(d, conv, zo_key) -> dict:
    """The cross-package session: every op whose result a realization
    fixes (the ZO job's search draws differ across packages, so its
    phases are written into the local twin before the readback)."""
    a = {k: conv(v) for k, v in _inputs().items()}
    out = {}
    d.write_signs(a["d_u"], a["d_v"])
    d.write_phases(a["phi_u"], a["phi_v"])
    d.write_sigma(a["sigma"])
    out["phi_u"], out["phi_v"] = d.read_phases()
    out["sigma"] = d.read_sigma()
    out["fwd"] = d.forward(a["x"])
    out["layer"] = d.forward_layer(a["xl"])
    out["batch"] = d.run_batch([("forward", dict(x=a["x"]))] * 2
                               + [("readback_bases", dict(cols=[0, 2]))])
    out["async"] = d.run_batch_async([("forward", dict(x=a["x"]))]).result()
    if zo_key is not None:
        res = d.zo_refine(a["w"], zo_key, ZOConfig(steps=8, inner=4))
        out["zo_phi"] = res.phi
    out["stats"] = d.stats.as_dict()
    return out


def _flat(v):
    if isinstance(v, (list, tuple)):
        return [x for e in v for x in _flat(e)]
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v,
                       np.float32)]


def _compare(remote: dict, local: dict) -> None:
    assert remote["stats"] == local["stats"]
    for name in ("phi_u", "phi_v", "sigma"):
        np.testing.assert_array_equal(_flat(remote[name])[0],
                                      _flat(local[name])[0], err_msg=name)
    for name in ("fwd", "layer", "batch", "async"):
        for r, loc in zip(_flat(remote[name]), _flat(local[name])):
            assert r.shape == loc.shape, name
            np.testing.assert_allclose(r, loc, atol=TOL, err_msg=name)


def test_port_client_against_the_reference_server(ref_server):
    """The port's client drives the reference's server: its results equal
    a port twin built from the remote realization."""
    key = wire_key(torch.Generator().manual_seed(42))
    d = SocketDriver(key, B, K, MODEL, m=M, n=N, address=ref_server,
                     device="cpu")
    try:
        assert d.protocol == 4
        remote = _session(d, torch.from_numpy, None)
        dev = d.unsafe_twin().dev
        u, v = d.readback_bases()
    finally:
        d.close()
    twin = make_twin(None, B, K, MODEL, m=M, n=N, dev=dev, device="cpu")
    local = _session(twin, torch.from_numpy, None)
    _compare(remote, local)
    for r, loc in zip((u, v), twin.readback_bases()):
        np.testing.assert_allclose(r.numpy(), loc.numpy(), atol=TOL)


def test_reference_client_against_the_port_server(port_server):
    """The reference's client drives the port's server (its ``jax.random``
    key seeds the port's twin; its ZO job runs on draws made from its
    key): every result equals a reference twin built from the remote
    realization, the meter included."""
    key = jax.random.PRNGKey(42)
    d = JSocketDriver(key, B, K, J_MODEL, m=M, n=N, address=port_server)
    conv = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    try:
        assert d.protocol == 4
        remote = _session(d, conv, jax.random.PRNGKey(3))
        h = d.unsafe_twin()
        dev = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                     h.dev)
        u, v = d.readback_bases()
    finally:
        d.close()
    twin = j_make_twin(key, B, K, J_MODEL, m=M, n=N, dev=dev)
    local = _session(twin, conv, None)
    t = K * (K - 1) // 2
    phi = np.asarray(remote["zo_phi"], np.float32)
    twin.write_phases(conv(phi[:, :t]), conv(phi[:, t:]))
    twin.charge("search", float(8 * 2 * B * K))
    local["stats"] = twin.stats.as_dict()
    _compare(remote, local)
    lu, lv = twin.readback_bases()
    for r, loc in ((u, lu), (v, lv)):
        np.testing.assert_allclose(np.asarray(r, np.float32),
                                   np.asarray(loc, np.float32), atol=TOL)


def test_pinned_v3_across_packages(ref_server, port_server):
    """A client pinned to v3 gets a JSON-line session from the other
    package's server, with the v4 session's bits."""
    key = wire_key(torch.Generator().manual_seed(1))
    x = torch.ones((2, K))
    ys = []
    for proto in (3, 4):
        d = SocketDriver(key, B, K, MODEL, address=ref_server, device="cpu",
                         protocol=proto)
        try:
            assert d.protocol == proto and d._binary == (proto == 4)
            ys.append(d.forward(x))
        finally:
            d.close()
    assert torch.equal(ys[0], ys[1])
    jd = JSocketDriver(jax.random.PRNGKey(1), B, K, J_MODEL,
                       address=port_server, protocol=3)
    try:
        assert jd.protocol == 3 and jd._binary is False
        assert np.asarray(jd.forward(jnp.ones((2, K)))).shape == (B, 2, K)
    finally:
        jd.close()


class _Announce:
    def __init__(self):
        self.port = None
        self.ready = threading.Event()

    def write(self, s):
        if s.startswith("LISTENING"):
            self.port = int(s.split()[1])
            self.ready.set()

    def flush(self):
        pass


def _thread_server(serve_socket, **kw):
    ann = _Announce()
    t = threading.Thread(target=serve_socket, args=("127.0.0.1", 0),
                         kwargs=dict(sessions=1, announce=ann, **kw),
                         daemon=True)
    t.start()
    assert ann.ready.wait(timeout=30)
    return t, ("127.0.0.1", ann.port)


def test_v4_clients_fall_back_to_the_other_packages_v3_only_server(
        monkeypatch):
    monkeypatch.setattr(jserver, "SUPPORTED_VERSIONS", (3,))
    t, addr = _thread_server(jserver.serve_socket)
    d = SocketDriver(wire_key(torch.Generator().manual_seed(2)), B, K, MODEL,
                     address=addr, device="cpu")
    try:
        assert d.protocol == 3 and d._binary is False
        x = torch.ones((2, K))
        y = d.forward(x)
        dev = d.unsafe_twin().dev
    finally:
        d.close()
    dev = type(dev)(*[type(n)(*[a.float() for a in n]) if isinstance(n, tuple)
                      else n.float() for n in dev])
    twin = make_twin(None, B, K, MODEL, dev=dev, device="cpu")
    np.testing.assert_allclose(y.float().numpy(), twin.forward(x).numpy(),
                               atol=TOL)
    t.join(timeout=30)

    monkeypatch.setattr(tserver, "SUPPORTED_VERSIONS", (3,))
    t, addr = _thread_server(tserver.serve_socket, device="cpu")
    jd = JSocketDriver(jax.random.PRNGKey(2), B, K, J_MODEL, address=addr)
    try:
        assert jd.protocol == 3 and jd._binary is False
        assert np.asarray(jd.forward(jnp.ones((2, K)))).shape == (B, 2, K)
    finally:
        jd.close()
    t.join(timeout=30)
    assert not t.is_alive()
