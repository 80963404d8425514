"""`SubprocessDriver`: op-stream client to a child twin server over pipes.

Counterpart of ``repro/hw/subprocess_driver.py``.  The hardware-in-the-loop
transport: the device (a ``python -m repro_torch.hw.server`` child hosting
a :class:`TwinDriver` on ``device``) lives outside this interpreter, and
the control plane reaches it only through the wire protocol.  Results are
bit-identical to :func:`~repro_torch.hw.make_driver`'s in-process twin for
the same construction key: the child runs the same code on the same
device, with the same number of torch threads, and raw array bytes cross
the pipe exactly.

All protocol behaviour lives in the shared
:class:`~repro_torch.hw.stream_driver.StreamDriver`; this class owns the
child and its binary stdin/stdout pipes.  The child's stderr goes to a
spool file (:func:`stderr_tail` reads it for error messages); at exit the
child writes its kernel launches there, which :meth:`close` adds to
:data:`server_launch_counts`.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..core.noise import NoiseModel
from .drift import DriftConfig
from .stream_driver import StreamDriver, RemoteTwinHandle  # noqa: F401

__all__ = ["SubprocessDriver", "RemoteTwinHandle", "server_env",
           "server_args", "stderr_tail", "server_launch_counts",
           "collect_launches"]

# kernel launches reported by server children this process has closed,
# by kernel name (each child reports its own on exit)
server_launch_counts: collections.Counter = collections.Counter()


def _src_root() -> str:
    # .../src/repro_torch/hw/subprocess_driver.py → .../src
    return str(Path(__file__).resolve().parents[2])


def server_env() -> dict:
    """Environment for a spawned twin server: the import path of this
    checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _src_root() + os.pathsep + env.get("PYTHONPATH", "")
    return env


def server_args(device, python: str | None = None) -> list[str]:
    """The command line of a server child for a twin on ``device``, with
    this process's torch thread count (CPU results then match the
    in-process twin's bit for bit)."""
    return [python or sys.executable, "-u", "-m", "repro_torch.hw.server",
            "--device", str(torch.device(device)),
            "--threads", str(torch.get_num_threads())]


def stderr_tail(spool, n: int = 2000) -> str:
    """Diagnostic tail of a spawned server's stderr spool file."""
    if spool is None:
        return ""
    try:
        spool.flush()
        with open(spool.name) as f:
            tail = f.read()[-n:]
    except OSError:
        return ""
    return "\nserver stderr tail:\n" + tail


def collect_launches(spool) -> dict:
    """The kernel launches a finished server child reported on its stderr
    spool (its ``KERNEL_LAUNCHES`` line), added to
    :data:`server_launch_counts`; {} if it reported none."""
    from .server import LAUNCH_MARK
    if spool is None:
        return {}
    try:
        spool.flush()
        with open(spool.name) as f:
            lines = [ln for ln in f if ln.startswith(LAUNCH_MARK)]
    except OSError:
        return {}
    if not lines:
        return {}
    counts = json.loads(lines[-1][len(LAUNCH_MARK):])
    server_launch_counts.update(counts)
    return counts


def open_spool():
    """A fresh stderr spool file for a server child."""
    return tempfile.NamedTemporaryFile(mode="w+", prefix="repro-hw-server-",
                                       suffix=".err", delete=False)


def close_spool(driver) -> None:
    """Delete a driver's stderr spool file."""
    if getattr(driver, "_stderr", None) is not None:
        try:
            driver._stderr.close()
            os.unlink(driver._stderr.name)
        except OSError:
            pass
        driver._stderr = None


class SubprocessDriver(StreamDriver):
    """Control-plane client to a ``repro_torch.hw.server`` child process.

    ``key`` is the construction key (:func:`~repro_torch.hw.driver.
    wire_key`); ``device`` is where the child's twin lives and where
    results land.  After :meth:`close`, ``server_launches`` holds the
    kernel launches the child reported."""

    def __init__(self, key, n_blocks: int, k: int, model: NoiseModel,
                 kind: str = "clements", *, m: int | None = None,
                 n: int | None = None, drift: DriftConfig | None = None,
                 device=None, python: str | None = None,
                 protocol: int | None = None):
        self._proc = None
        self._stderr = None
        self.server_launches: dict = {}
        try:
            self._stderr = open_spool()
            # binary pipes with 1 MiB buffers (a batched frame is ~100 KB
            # to a few MB)
            self._proc = subprocess.Popen(
                server_args("cuda" if device is None else device, python),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=self._stderr, env=server_env(), bufsize=1 << 20)
            self._fin = self._proc.stdout
            self._fout = self._proc.stdin
            self._handshake(key, n_blocks, k, model, kind, m, n, drift,
                            protocol=protocol, device=device)
        except Exception:
            # a half-built driver must not leak the child or the spool
            self.close()
            raise

    # -- transport hooks -----------------------------------------------------

    def _transport_alive(self) -> bool:
        return (getattr(self, "_proc", None) is not None
                and self._proc.poll() is None)

    def _transport_diagnostics(self) -> str:
        if getattr(self, "_proc", None) is None:
            return ""
        return stderr_tail(self._stderr)

    def close(self) -> None:
        proc = getattr(self, "_proc", None)
        if proc is not None:
            try:
                if proc.poll() is None:
                    self._shutdown_stream()
                    proc.wait(timeout=30)
            except Exception:
                proc.kill()
                proc.wait(timeout=5)
            self._proc = None
            self._fin = self._fout = None
            self.server_launches = collect_launches(self._stderr)
        close_spool(self)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
