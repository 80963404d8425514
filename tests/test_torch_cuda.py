"""The port's CUDA kernels on the card: what only a card can show.

Every test here is marked ``cuda`` and skips without a card.  Run them on
a machine with one (the file imports neither ``jax`` nor the reference
package, so the repository's conftest is not needed)::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

* ``paged_gather`` and ``paged_scatter`` stop with a device trap when a
  page id or offset lies outside the pool, as their plain versions raise:
  a bad target never loses a KV write, or reads zeros, in silence.  A trap
  ends the CUDA context, so each case runs in a subprocess of its own.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

SRC = Path(__file__).resolve().parents[1] / "src"

# pool: 4 pages of 2 rows of 8 bf16; the target (or page id) goes in argv
_SCRIPT = """
import sys
import torch
from repro_torch.kernels import paged_gather, paged_scatter
kernel, page, off = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda")
pool = torch.zeros((4, 2, 8), dtype=torch.bfloat16, device=dev)
if kernel == "gather":
    table = torch.tensor([[0, page]], dtype=torch.int32, device=dev)
    out = paged_gather(table, pool)
else:
    idx = torch.tensor([[1, 0], [page, off]], dtype=torch.int32, device=dev)
    out = paged_scatter(idx, torch.ones((2, 8), dtype=torch.bfloat16,
                                        device=dev), pool)
torch.cuda.synchronize()
print("DONE", float(out.float().sum()))
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")


def _run(kernel, page, off):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-c", _SCRIPT, kernel, str(page),
                           str(off)], capture_output=True, text=True,
                          env=env, timeout=600)


@pytest.mark.parametrize("kernel, page, off, total", [
    ("gather", 3, 0, 0.0),           # in the pool: the control case
    ("scatter", 3, 1, 16.0),
])
def test_paged_kernels_run_on_targets_in_the_pool(card, kernel, page, off,
                                                  total):
    res = _run(kernel, page, off)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"DONE {total}" in res.stdout


@pytest.mark.parametrize("kernel, page, off", [
    ("gather", 4, 0), ("gather", -1, 0),
    ("scatter", 4, 0), ("scatter", -1, 0), ("scatter", 0, 2),
    ("scatter", 0, -1),
])
def test_paged_kernels_trap_on_targets_outside_the_pool(card, kernel, page,
                                                        off):
    res = _run(kernel, page, off)
    assert res.returncode != 0 and "DONE" not in res.stdout, res.stdout
    assert "CUDA error" in res.stderr or "cuda" in res.stderr.lower(), \
        res.stderr[-2000:]
