"""`SocketDriver`: the op-stream driver protocol over a TCP socket.

Counterpart of ``repro/hw/socket_driver.py``.  Same framing, same op
surface and the same bits as the pipe transport, but the twin server can
live on another host: point the driver at ``address=(host, port)`` where
``python -m repro_torch.hw.server --socket HOST:PORT`` (or the reference's
``python -m repro.hw.server --socket HOST:PORT``) listens, and the whole
control plane runs against the remote device unchanged.  The server is
concurrent (a thread per connection), so a whole fleet can share one
server process, a session each.

With ``address=None`` the driver self-hosts: it spawns a server child on
``device`` bound to an ephemeral loopback port (``--socket 127.0.0.1:0
--sessions 1``), reads the announced port off the child's stdout within
``connect_timeout`` and connects; any failure on the way tears the child
and its stderr spool down before the exception propagates.  After
:meth:`close` a self-hosted child's kernel launches are in
``server_launches`` (and added to
:data:`~repro_torch.hw.subprocess_driver.server_launch_counts`).

``TCP_NODELAY`` is set: the protocol is request/response, and Nagle's
algorithm would stall every small frame on a delayed ACK.
"""

from __future__ import annotations

import os
import select
import socket
import subprocess
import time

from ..core.noise import NoiseModel
from .drift import DriftConfig
from .protocol import ProtocolError
from .stream_driver import StreamDriver
from .subprocess_driver import (server_env, server_args, stderr_tail,
                                collect_launches, open_spool, close_spool)

__all__ = ["SocketDriver"]


class SocketDriver(StreamDriver):
    """Control-plane client to a twin server over TCP."""

    def __init__(self, key, n_blocks: int, k: int, model: NoiseModel,
                 kind: str = "clements", *, m: int | None = None,
                 n: int | None = None, drift: DriftConfig | None = None,
                 address: tuple[str, int] | None = None, device=None,
                 python: str | None = None, connect_timeout: float = 60.0,
                 protocol: int | None = None):
        self._proc = None
        self._stderr = None
        self._sock = None
        self.server_launches: dict = {}
        try:
            if address is None:
                # self-hosted: spawn a loopback server child, learn its port
                self._stderr = open_spool()
                self._proc = subprocess.Popen(
                    server_args("cuda" if device is None else device, python)
                    + ["--socket", "127.0.0.1:0", "--sessions", "1"],
                    stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
                    stderr=self._stderr, env=server_env())
                line = self._read_announce(connect_timeout)
                if not line.startswith("LISTENING "):
                    raise ProtocolError(
                        f"socket server failed to announce its port: "
                        f"{line!r}" + self._transport_diagnostics())
                address = ("127.0.0.1", int(line.split()[1]))
            self._sock = socket.create_connection(address,
                                                  timeout=connect_timeout)
            self._sock.settimeout(None)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._fin = self._sock.makefile("rb", buffering=1 << 20)
            self._fout = self._sock.makefile("wb", buffering=1 << 20)
            self._handshake(key, n_blocks, k, model, kind, m, n, drift,
                            protocol=protocol, device=device)
        except Exception:
            self.close()
            raise

    def _read_announce(self, timeout: float) -> str:
        """Bounded read of the child's ``LISTENING <port>`` line: a child
        that dies before binding hits EOF, one that never announces hits
        the deadline, and construction fails promptly either way."""
        fd = self._proc.stdout.fileno()
        deadline = time.monotonic() + timeout
        buf = b""
        while b"\n" not in buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ProtocolError(
                    f"socket server did not announce its port within "
                    f"{timeout:.1f}s" + self._transport_diagnostics())
            ready, _, _ = select.select([fd], [], [], remaining)
            if not ready:
                continue
            chunk = os.read(fd, 4096)
            if not chunk:
                raise ProtocolError(
                    "socket server exited before announcing its port"
                    + self._transport_diagnostics())
            buf += chunk
        return buf.split(b"\n", 1)[0].decode("utf-8", "replace")

    # -- transport hooks -----------------------------------------------------

    def _transport_alive(self) -> bool:
        return getattr(self, "_sock", None) is not None

    def _transport_diagnostics(self) -> str:
        return stderr_tail(self._stderr)

    def close(self) -> None:
        sock = getattr(self, "_sock", None)
        if sock is not None:
            self._shutdown_stream()
            try:
                self._fin.close()
                self._fout.close()
            except Exception:
                pass
            try:
                sock.close()
            except OSError:
                pass
            self._sock = None
            self._fin = self._fout = None
        if getattr(self, "_proc", None) is not None:
            if sock is None:
                # construction never reached a session: the child waits in
                # accept() and will not exit on its own
                self._proc.kill()
            try:
                self._proc.wait(timeout=30)
            except Exception:
                self._proc.kill()
                self._proc.wait(timeout=5)
            self._proc = None
            self.server_launches = collect_launches(self._stderr)
        close_spool(self)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
