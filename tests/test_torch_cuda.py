"""The port's CUDA kernels on the card: what only a card can show.

Every test here is marked ``cuda`` and skips without a card.  Run them on
a machine with one (the file imports neither ``jax`` nor the reference
package, so the repository's conftest is not needed)::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

* ``paged_gather`` and ``paged_scatter`` stop with a device trap when a
  page id or offset lies outside the pool, as their plain versions raise:
  a bad target never loses a KV write, or reads zeros, in silence.  A trap
  ends the CUDA context, so each case runs in a subprocess of its own.
* ``prefill_attention`` on the tensor cores (bf16 q over bf16 K/V, Dh 64
  and 128) against ``ref.prefill_attention_ref`` on the same bf16 inputs:
  the 12 (blk, window, cap) cases at GQA ratios 1, 2, 4 and 16, query rows
  and key counts that are not multiples of the 64-wide tiles, lens at 0 and
  at S - C; max |error| at most 2^-7 (one bf16 ulp) of the largest |out|,
  reruns bitwise equal, every call on the tensor-core route.  A block
  outside the window changes no bit; a one-key mask leak reads above 2^-7.
* ``feedback_matmul`` against ``ref.feedback_matmul_ref`` at masks of
  density 0, 0.5, 1 and btopk 0.6, k in 4, 8, 9, 13, 16, 32: 1e-4 of the
  largest |dx|, density 0 an exact zero, reruns bitwise equal.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.sparsity import SparsityConfig, feedback_mask
from repro_torch.kernels import build, feedback_matmul, prefill_attention, ref
from repro_torch.kernels.prefill_attn import NAME, NAME_CUDA_CORES

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


def _rel(a, b):
    """max |a - b| over the largest |b|"""
    return float((a.float() - b.float()).abs().max()) \
        / (float(b.float().abs().max()) + 1e-6)


# (B, C, H, Hkv, Dh, S, lens): rep 4, 16, 1, 2; C·rep of 52, 80, 37, 100
# rows; S of 200, 72, 136, 640 keys; the last slot at lens = S - C
_PREFILL = [(3, 13, 8, 2, 128, 200, [0, 100, 187]),
            (2, 5, 16, 1, 64, 72, [0, 67]),
            (2, 37, 3, 3, 64, 136, [0, 99]),
            (2, 50, 4, 2, 128, 640, [0, 590])]


def _bf16_inputs(geom, seed=0):
    b, c, h, hkv, hd, s, ln = geom
    gen = torch.Generator("cuda").manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, c, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    return torch.tensor(ln, dtype=torch.int32, device="cuda"), q, k, v


@pytest.mark.parametrize("geom", _PREFILL)
@pytest.mark.parametrize("blk", [None, 8, 4])
@pytest.mark.parametrize("window,cap", [(None, None), (6, None), (None, 3.0),
                                        (5, 2.0)])
def test_tensor_core_prefill_matches_plain_version(card, geom, blk, window,
                                                   cap):
    lens, q, k, v = _bf16_inputs(geom)
    before = dict(build.launch_counts)
    kw = dict(blk=blk, window=window, cap=cap)
    got = prefill_attention(lens, q, k, v, **kw)
    again = prefill_attention(lens, q, k, v, **kw)
    want = ref.prefill_attention_ref(lens, q, k, v, window=window, cap=cap)
    torch.cuda.synchronize()
    assert build.launch_counts[NAME] - before[NAME] == 2
    assert build.launch_counts[NAME_CUDA_CORES] == before[NAME_CUDA_CORES]
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    assert _rel(got, want) <= 2 ** -7


@pytest.mark.parametrize("geom", _PREFILL)
def test_tensor_core_prefill_catches_a_one_key_mask_leak(card, geom):
    lens, q, k, v = _bf16_inputs(geom, seed=1)
    got = prefill_attention(lens, q, k, v)
    assert _rel(got, ref.prefill_attention_ref(lens + 1, q, k, v)) > 2 ** -7


def test_tensor_core_prefill_block_outside_the_window_changes_no_bit(card):
    # queries at 128..135 with window 20 see keys 109 and up: keys 0-100
    # fill tile 0 (skipped) and most of tile 1 (masked inside a live tile)
    lens, q, k, v = _bf16_inputs((1, 8, 4, 2, 64, 136, [128]), seed=2)
    base = prefill_attention(lens, q, k, v, window=20)
    k2, v2 = k.clone(), v.clone()
    k2[:, :101], v2[:, :101] = 999.0, -999.0
    assert torch.equal(base, prefill_attention(lens, q, k2, v2, window=20))


@pytest.mark.parametrize("t,p,q,k", [(100, 2, 3, 4), (16, 3, 2, 8),
                                     (37, 3, 5, 9), (1000, 3, 5, 13),
                                     (32, 4, 4, 16), (129, 2, 2, 32),
                                     (1024, 57, 456, 9)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0, "btopk"])
def test_feedback_matmul_matches_plain_version(card, t, p, q, k, density):
    gen = torch.Generator("cuda").manual_seed(t + k)
    dy, u, s, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((t, p * k), (p, q, k, k), (p, q, k),
                                 (p, q, k, k)))
    if density == "btopk":
        mask = feedback_mask(gen, torch.rand((p, q), generator=gen,
                                             device="cuda"),
                             SparsityConfig(alpha_w=0.6,
                                            feedback_mode="btopk"))
    else:
        mask = (torch.rand((q, p), generator=gen, device="cuda")
                < density).float() * 2.0
    dx = feedback_matmul(dy, u, s, v, mask)
    again = feedback_matmul(dy, u, s, v, mask)
    want = ref.feedback_matmul_ref(dy, u, s, v, mask)
    torch.cuda.synchronize()
    assert dx.shape == want.shape and torch.equal(dx, again)
    if density == 0.0:
        assert int(torch.count_nonzero(dx)) == 0
    else:
        assert _rel(dx, want) < 1e-4
