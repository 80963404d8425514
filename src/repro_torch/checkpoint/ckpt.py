"""Atomic checkpoints in the reference's format.

Counterpart of ``repro/checkpoint/ckpt.py``:

* **Format** — ``<dir>/step_<n>/arrays.npz``, every leaf of the state
  tree under its "/"-joined path (dict keys, sequence indices and
  NamedTuple field names, ``OptState``'s ``step`` included), plus
  ``meta.json`` (step, save time and the caller's metadata).  A bf16
  tensor is stored as its raw 16-bit words (numpy has no bf16) and
  restored bit-exactly into the template's bf16 leaf.
* **Atomicity** — written to ``<dir>/tmp.<step>``, then renamed to
  ``<dir>/step_<n>``; a restore sees only fully renamed directories.
* **Keep-last-k** and a SIGTERM handler that asks for a save at the next
  step boundary (:class:`CheckpointManager`).

Arrays are saved as full host tensors and restored onto the template's
leaves' devices.  The reference's re-sharding on restore (an elastic
restart on another device mesh) has no counterpart on one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import time
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "all_steps", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _items(node):
    """(key, child) pairs of a dict, NamedTuple, list or tuple; None for a
    leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix=()) -> dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {"/".join(map(str, prefix)): tree}
    out = {}
    for key, child in items:
        out.update(_flatten(child, prefix + (key,)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if like.dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def _unflatten(like, data, prefix=()):
    items = _items(like)
    if items is None:
        return _from_numpy(data["/".join(map(str, prefix))], like)
    kids = [(k, _unflatten(c, data, prefix + (k,))) for k, c in items]
    if isinstance(like, dict):
        return dict(kids)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(c for _, c in kids))
    return type(like)(c for _, c in kids)


def save_checkpoint(directory: str, step: int, tree,
                    metadata: dict | None = None, keep: int = 3) -> str:
    """Write ``tree`` as ``<directory>/step_<step>``; keep the last
    ``keep`` checkpoints (all when ``keep`` <= 0)."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k: _to_numpy(v) for k, v in _flatten(tree).items()})
    meta = {"step": step, "time": time.time(), **(metadata or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # the atomic commit point
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like, step: int | None = None
                       ) -> tuple[Any, dict]:
    """Restore into the structure, dtypes and devices of ``like`` (the
    latest step unless ``step`` is given): (tree, metadata)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return _unflatten(like, data), meta


class CheckpointManager:
    """Keep-last-k manager with SIGTERM-triggered preemption saves and a
    periodic cadence::

        mgr = CheckpointManager(dir, every=100)
        try:
            for step in ...:
                ...
                mgr.maybe_save(step, state)      # periodic + preemption
        finally:
            mgr.close()

    Until :meth:`close`, SIGTERM only sets :attr:`preempted`; ``close``
    puts back the handler it replaced."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3,
                 install_sigterm: bool = True):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._preempted = False
        self._installed = False
        self._previous = None       # the SIGTERM handler to put back
        if install_sigterm:
            try:
                self._previous = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
                self._installed = True
            except ValueError:
                pass    # not the main thread

    def close(self) -> None:
        """Put back the SIGTERM handler this manager replaced."""
        if self._installed:
            # None: the old handler was not set from Python
            signal.signal(signal.SIGTERM, self._previous or signal.SIG_DFL)
            self._installed = False

    def _on_sigterm(self, signum, frame):
        self._preempted = True

    @property
    def preempted(self) -> bool:
        return self._preempted

    def maybe_save(self, step: int, tree, metadata: dict | None = None
                   ) -> bool:
        due = (step % self.every == 0) or self._preempted
        if due:
            save_checkpoint(self.directory, step, tree, metadata, self.keep)
        return due

    def restore_or_none(self, like):
        if latest_step(self.directory) is None:
            return None, None
        return restore_checkpoint(self.directory, like)
