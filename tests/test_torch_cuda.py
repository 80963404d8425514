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
* ``ptc_block_matmul`` on both routes (the per-block route wherever
  Q = 1) against ``ref.ptc_block_matmul_ref`` at k in 4, 8, 9, 13, 16,
  32, fp32 (1e-4 of the largest |y|) and bf16 (6e-2), rows of x and y
  that are not 16-byte aligned (Q·k 27 and 513, P·k 135, 261 and 513)
  and ragged T; reruns bitwise; the crossover at ``PER_BLOCK_MAX_T``;
  split-K plans rerun bitwise and agree with the unsplit product; the
  kernel's tile is the wrapper plan's.
* ``sigma_grad`` against ``ref.sigma_grad_ref`` and against
  ``torch.autograd`` of the plain forward (1e-4 of the largest |ds|) at
  the same k, widths and ragged T; split-T plans rerun bitwise.
* bf16 operands on the k <= 32 routes of ``sigma_grad`` and
  ``feedback_matmul`` (ds fp32 at 1e-4; dx bf16 within one bf16 ulp of
  the largest entry, 2^-7).
* The wide routes (k > 32) of ``ptc_block_matmul``, ``sigma_grad`` and
  ``feedback_matmul`` against their plain versions at k 33, 64, 100 and
  128, fp32 (1e-4) and bf16 (2^-7 for the bf16 outputs y and dx; ds at
  1e-4), T at the 128-row tile's edges, feedback masks of density 0, 0.5,
  1 and btopk; reruns bitwise, every call on the wide route; the kernel's
  tile is the wrapper's ``WIDE_TILE``.  ``mesh_apply``'s narrow route
  (k 2 to 32, each compiled pattern and the slot tables, both output
  layouts) and wide routes (``build_unitary`` and rows of their own, reck
  and clements; the unrolled kernel at k 64 and 128 also over 1000 rows
  in both layouts, with and without signs, U Uᵀ - I below 1e-4, and the
  list-driven kernel forced beside it) at 1e-5.
* The tensor-core routes (bf16 at k 64 and 128) of ``ptc_block_matmul``,
  ``sigma_grad`` and ``feedback_matmul`` against their plain versions and
  the plain emulations of their roundings (the feedback at masks of
  density 0, 0.5, 1 and btopk, olmo-1b's up projection among its shapes),
  T 1 to 4096, P or Q ragged against the 128 × 128 tile at k = 64, with
  and without a column scale off bf16's grid: y within 2^-7 of its
  largest entry, ds within 1e-4 and its least-squares scale within 5e-4
  of 1; reruns bitwise; the column scale bit for bit the kernel fed the
  plain bf16 split of the fp32 product;
  ``force_route="wide"`` still reaches the CUDA cores for bf16 in all
  three, and ``"wide_tc"`` is refused for fp32 and k = 100; the kernel's
  tile is the wrapper's ``TC_TILE``.
* The 3xTF32 routes (fp32 at k 64 and 128) of ``ptc_block_matmul`` and
  ``sigma_grad`` against the fp32 plain versions and their 3xTF32
  emulations, T 1, 127, 128, 129 and 300, P or Q odd at k = 64, with and
  without a column scale off bf16's grid: y and ds within 1e-5 of the
  largest entry, ds's least-squares scale within 5e-4 of 1; reruns
  bitwise; ``force_route="wide"`` still reaches the CUDA cores for fp32,
  ``"wide_3xtf32"`` is refused for bf16 and k 32 and 100; the kernel's
  tile is the wrapper's ``TF32X3_TILE``.  The 3xTF32 ``feedback_matmul``
  (fp32 at k 64 and 128) against the fp32 plain version and its 3xTF32
  emulation at 1e-5: T 1 to 4096, P or Q odd, olmo-1b's up projection,
  masks of density 0, 0.5, 1 and btopk (density 0, and a q row masked
  everywhere in either half of a 128-column tile, exact zeros); reruns
  bitwise.
* The CUDA-core ``prefill_attention`` route (fp32 q; fp32 q over bf16
  K/V; bf16 at head dims other than 64 and 128) over the 12 (blk, window,
  cap) cases at 2e-5, head dims 5, 96, 200 and 256, reruns bitwise; a
  block outside the window changes no bit; every ``blk`` that divides the
  view gives the same bits (the kernel reads none).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.sparsity import SparsityConfig, feedback_mask
from repro_torch.kernels import (build, feedback_matmul, prefill_attention,
                                 ptc_block_matmul, ref, sigma_grad)
from repro_torch.kernels.prefill_attn import NAME, NAME_CUDA_CORES
from repro_torch.kernels.ptc_block_matmul import (K_STAGE, PER_BLOCK_MAX_T,
                                                  ROUTES, TC_K, TC_TILE,
                                                  TF32X3_TILE, WIDE_TILE,
                                                  Plan, route, tc_lib,
                                                  tf32x3_lib, wide_lib)
from repro_torch.kernels.ptc_block_matmul import plan as product_plan
from repro_torch.kernels.sigma_grad import Plan as SigmaPlan
from repro_torch.kernels.sigma_grad import plan as sigma_plan

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


# (T, P, Q, k): every compiled k (13 runs in the 16 kernel), rows of x
# (Q·k 27, 513) and y (P·k 135, 261, 513) off 16-byte alignment, ragged T,
# Q = 1 shapes for the per-block route
_PTC = [(100, 2, 3, 4), (16, 3, 2, 8), (37, 3, 5, 9), (1000, 3, 5, 13),
        (64, 4, 4, 16), (129, 2, 2, 32), (300, 8, 3, 9), (129, 15, 3, 9),
        (70, 29, 5, 9), (33, 57, 6, 9), (32, 2, 57, 9), (9, 500, 1, 9),
        (13, 40, 1, 13), (33, 64, 1, 4), (9, 30, 1, 32), (5, 33, 1, 16)]


def _ptc_inputs(t, p, q, k, dtype=torch.float32, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed + t + p + q + k)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((t, q * k), (p, q, k, k), (p, q, k), (p, q, k, k))]


@pytest.mark.parametrize("t,p,q,k", _PTC)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6e-2)])
def test_ptc_block_matmul_routes_match_plain_version(card, t, p, q, k, dtype,
                                                     tol):
    x, u, s, v = _ptc_inputs(t, p, q, k, dtype)
    want = ref.ptc_block_matmul_ref(x, u, s, v)
    for which in ("product", "per_block") if q == 1 else ("product",):
        before = build.launch_counts[ROUTES[which]]
        y = ptc_block_matmul(x, u, s, v, force_route=which)
        again = ptc_block_matmul(x, u, s, v, force_route=which)
        torch.cuda.synchronize()
        assert build.launch_counts[ROUTES[which]] - before == 2
        assert y.dtype == dtype and torch.equal(y, again)
        assert _rel(y, want) < tol, which


@pytest.mark.parametrize("t", [PER_BLOCK_MAX_T - 1, PER_BLOCK_MAX_T,
                               PER_BLOCK_MAX_T + 1])
def test_ptc_block_matmul_crossover_launches_the_route_the_rule_names(card,
                                                                      t):
    x, u, s, v = _ptc_inputs(t, 200, 1, 9)
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v)
    which = route(t, 200, 1, 9)
    assert which == ("per_block" if t <= PER_BLOCK_MAX_T else "product")
    for name, counter in ROUTES.items():
        assert build.launch_counts[counter] - before[counter] \
            == (name == which)
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < 1e-4


@pytest.mark.parametrize("t,p,q,k", [(32, 57, 456, 9), (1024, 57, 456, 9),
                                     (40, 3, 20, 13), (40, 3, 20, 32)])
def test_ptc_block_matmul_split_k_plans_rerun_bitwise(card, t, p, q, k):
    x, u, s, v = _ptc_inputs(t, p, q, k)
    want = ref.ptc_block_matmul_ref(x, u, s, v)
    base = product_plan(t, p, q, k)
    ktiles = -(-(q * k) // K_STAGE)
    for splits in (1, 3, base.splits, ktiles):
        kt = -(-ktiles // splits)
        pl = base._replace(splits=-(-ktiles // kt), kc=K_STAGE * kt)
        y = ptc_block_matmul(x, u, s, v, force_plan=pl)
        assert torch.equal(y, ptc_block_matmul(x, u, s, v, force_plan=pl))
        assert _rel(y, want) < 1e-4, pl


def test_ptc_block_matmul_kernel_tile_is_the_plan(card):
    import ctypes
    out = (ctypes.c_int * 3)()
    lib = build.library("ptc_block_matmul")
    for k in (1, 4, 5, 8, 9, 13, 16, 17, 32):
        for p in (1, 2, 8, 9, 57):
            pl = product_plan(64, p, 3, k)
            assert isinstance(pl, Plan)
            assert lib.ptc_block_matmul_tile(k, pl.wn, out) == 0
            assert tuple(out) == (pl.bm, pl.nblk, K_STAGE)


_SIGMA = [(100, 2, 3, 4), (16, 3, 2, 8), (37, 3, 5, 9), (1000, 3, 5, 13),
          (64, 4, 4, 16), (129, 2, 2, 32), (300, 8, 3, 9), (129, 15, 3, 9),
          (70, 29, 5, 9), (33, 57, 6, 9), (32, 2, 57, 9), (17, 9, 17, 9),
          (4096, 8, 64, 9)]


def _sigma_inputs(t, p, q, k, seed=0):
    gen = torch.Generator("cuda").manual_seed(seed + t + p + q + k)
    return [torch.randn(shape, generator=gen, device="cuda")
            for shape in ((t, p * k), (t, q * k), (p, q, k, k), (p, q, k),
                          (p, q, k, k))]


@pytest.mark.parametrize("t,p,q,k", _SIGMA)
def test_sigma_grad_matches_plain_version_and_autograd(card, t, p, q, k):
    dy, x, u, s, v = _sigma_inputs(t, p, q, k)
    ds = sigma_grad(dy, x, u, v)
    assert torch.equal(ds, sigma_grad(dy, x, u, v))
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v)) < 1e-4
    s = s.clone().requires_grad_()
    (ref.ptc_block_matmul_ref(x, u, s, v) * dy).sum().backward()
    assert _rel(ds, s.grad) < 1e-4


@pytest.mark.parametrize("t,p,q,k", [(4096, 8, 64, 9), (1000, 3, 5, 13),
                                     (517, 2, 3, 32), (300, 20, 40, 4)])
def test_sigma_grad_split_t_plans_rerun_bitwise(card, t, p, q, k):
    dy, x, u, _, v = _sigma_inputs(t, p, q, k, seed=1)
    want = ref.sigma_grad_ref(dy, x, u, v)
    base = sigma_plan(t, p, q, k)
    for chunk in (16, 48, 256, -(-t // 16) * 16):
        pl = base._replace(splits=-(-t // chunk), chunk_rows=chunk)
        assert isinstance(pl, SigmaPlan)
        ds = sigma_grad(dy, x, u, v, force_plan=pl)
        assert torch.equal(ds, sigma_grad(dy, x, u, v, force_plan=pl))
        assert _rel(ds, want) < 1e-4, pl


def _masks(gen, q, p, density):
    if density == "btopk":
        return feedback_mask(gen, torch.rand((p, q), generator=gen,
                                             device="cuda"),
                             SparsityConfig(alpha_w=0.6,
                                            feedback_mode="btopk"))
    return (torch.rand((q, p), generator=gen, device="cuda")
            < density).float() * 2.0


@pytest.mark.parametrize("t,p,q,k", [(100, 3, 5, 9), (129, 2, 2, 32),
                                     (1000, 3, 5, 13)])
@pytest.mark.parametrize("density", [0.5, "btopk"])
def test_narrow_backward_routes_take_bf16(card, t, p, q, k, density):
    dy, x, u, s, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(t, p, q, k, seed=2))
    gen = torch.Generator("cuda").manual_seed(t)
    mask = _masks(gen, q, p, density)
    before = dict(build.launch_counts)
    ds = sigma_grad(dy, x, u, v)
    dx = feedback_matmul(dy, u, s, v, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["sigma_grad"] - before["sigma_grad"] == 1
    assert build.launch_counts["feedback_matmul"] \
        - before["feedback_matmul"] == 1
    assert ds.dtype == torch.float32 and dx.dtype == torch.bfloat16
    assert torch.equal(ds, sigma_grad(dy, x, u, v))
    assert torch.equal(dx, feedback_matmul(dy, u, s, v, mask))
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v)) < 1e-4
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 2 ** -7


_WIDE = [(37, 2, 3, 33), (64, 2, 2, 64), (129, 3, 2, 100), (127, 3, 3, 128),
         (128, 2, 3, 128), (129, 3, 2, 128), (1, 1, 1, 128)]


@pytest.mark.parametrize("t,p,q,k", _WIDE)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0, "btopk"])
def test_wide_ptc_routes_match_plain_version(card, t, p, q, k, dtype,
                                             density):
    dy, x, u, s, v = (a.to(dtype) for a in _sigma_inputs(t, p, q, k))
    gen = torch.Generator("cuda").manual_seed(t + k)
    mask = _masks(gen, q, p, density)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    # at k 64 and 128: the three on the tensor cores, for bf16 in bf16, for
    # fp32 in 3xTF32 (dx then within 1e-5)
    tc = "_tc" if dtype == torch.bfloat16 and k in TC_K else ""
    x3 = "_3xtf32" if dtype == torch.float32 and k in TC_K else ""
    tol_dx = 1e-5 if x3 else tol
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v)
    ds = sigma_grad(dy, x, u, v)
    dx = feedback_matmul(dy, u, s, v, mask)
    torch.cuda.synchronize()
    launched = ("ptc_block_matmul_wide" + tc + x3,
                "sigma_grad_wide" + tc + x3,
                "feedback_matmul_wide" + tc + x3)
    for name in launched:
        assert build.launch_counts[name] - before[name] == 1, name
    for name in ("ptc_block_matmul", "ptc_block_matmul_perblock",
                 "sigma_grad", "feedback_matmul", "ptc_block_matmul_wide",
                 "ptc_block_matmul_wide_tc", "ptc_block_matmul_wide_3xtf32",
                 "sigma_grad_wide", "sigma_grad_wide_tc",
                 "sigma_grad_wide_3xtf32", "feedback_matmul_wide",
                 "feedback_matmul_wide_tc", "feedback_matmul_wide_3xtf32"):
        if name not in launched:
            assert build.launch_counts[name] == before[name], name
    assert y.dtype == dtype and dx.dtype == dtype
    assert torch.equal(y, ptc_block_matmul(x, u, s, v))
    assert torch.equal(ds, sigma_grad(dy, x, u, v))
    assert torch.equal(dx, feedback_matmul(dy, u, s, v, mask))
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < tol
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v)) < 1e-4
    if density == 0.0:
        assert int(torch.count_nonzero(dx)) == 0
    else:
        assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < tol_dx


@pytest.mark.parametrize("t,p,q,k", [(100, 3, 5, 9), (129, 2, 2, 32),
                                     (37, 2, 3, 33), (129, 3, 2, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sigma_grad_column_scale_is_fp32_on_both_routes(card, t, p, q, k,
                                                        dtype):
    # a normalizer off bf16's grid (column_norm "exp" at α_C = 0.6): the
    # kernel scales δy in fp32, bit for bit as if δy came widened and
    # scaled; the pre-scaled fp32 call is itself checked above
    dy, x, u, _, v = (a.to(dtype) for a in _sigma_inputs(t, p, q, k))
    gen = torch.Generator("cuda").manual_seed(t)
    col = (torch.rand((t,), generator=gen, device="cuda") < 0.6).float() \
        / 0.6
    ds = sigma_grad(dy, x, u, v, col)
    if dtype == torch.bfloat16 and k in TC_K:
        # the tensor cores take col ⊙ δy, formed in fp32, as bf16 hi + lo:
        # bit for bit the kernel fed the plain split of the fp32 product
        want = _tc_sigma_of_parts(
            *ref.split_bf16(dy.float() * col[:, None]), x, u, v)
    else:
        want = sigma_grad((dy.float() * col[:, None]).contiguous(),
                          x.float(), u.float(), v.float())
    assert torch.equal(ds, want)
    assert torch.equal(ds, sigma_grad(dy, x, u, v, col))
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v, col)) < 1e-4


def _tc_sigma_of_parts(hi, lo, x, u, v):
    """The tensor-core Σ-gradient's library entry over the given bf16 parts
    of δy (hi, then lo into the same accumulator)."""
    p, q, k, _ = u.shape
    ds = torch.empty((p, q, k), dtype=torch.float32, device="cuda")
    status = tc_lib().ptc_tc_sigma(
        hi.data_ptr(), lo.data_ptr(), x.data_ptr(), u.data_ptr(),
        v.data_ptr(), 0, 0, 0, ds.data_ptr(), hi.shape[0], p, q, k,
        torch.cuda.current_stream().cuda_stream)
    build.check_status("ptc_wide_tc", status)
    return ds


_TC = [(1, 1, 1, 128), (100, 3, 2, 128), (4096, 2, 3, 128), (1, 2, 3, 64),
       (100, 3, 3, 64), (4096, 3, 5, 64), (129, 1, 2, 128), (192, 5, 1, 64)]


@pytest.mark.parametrize("t,p,q,k", _TC)
@pytest.mark.parametrize("with_col", [False, True])
def test_wide_tc_matches_plain_version(card, t, p, q, k, with_col):
    """bf16 at k 64 and 128 on the tensor cores: y within 2^-7 of its
    largest entry (U diag(s), W and y rounded to bf16), ds within 1e-4
    with and without a column scale off bf16's grid; reruns bitwise; the
    CUDA-core wide counters untouched."""
    dy, x, u, s, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(t, p, q, k, seed=7))
    gen = torch.Generator("cuda").manual_seed(t + k)
    col = (torch.rand((t,), generator=gen, device="cuda") < 0.6).float() \
        / 0.6 if with_col else None
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v)
    ds = sigma_grad(dy, x, u, v, col)
    torch.cuda.synchronize()
    assert build.launch_counts["ptc_block_matmul_wide_tc"] \
        - before["ptc_block_matmul_wide_tc"] == 1
    assert build.launch_counts["sigma_grad_wide_tc"] \
        - before["sigma_grad_wide_tc"] == 1
    for name in ("ptc_block_matmul_wide", "sigma_grad_wide"):
        assert build.launch_counts[name] == before[name], name
    assert y.dtype == torch.bfloat16 and ds.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < 2 ** -7
    assert _rel(y, ref.ptc_block_matmul_tc_ref(x, u, s, v)) < 2 ** -7
    want = ref.sigma_grad_ref(dy, x, u, v, col)
    assert _rel(ds, want) < 1e-4
    assert _rel(ds, ref.sigma_grad_tc_ref(dy, x, u, v, col)) < 1e-4
    if bool(want.any()):
        ratio = float((ds.double() * want.double()).sum()
                      / (want.double() ** 2).sum())
        assert abs(ratio - 1.0) < 5e-4
    else:                                # T = 1 with its column dropped
        assert not bool(ds.any())
    assert torch.equal(y, ptc_block_matmul(x, u, s, v))
    assert torch.equal(ds, sigma_grad(dy, x, u, v, col))


@pytest.mark.parametrize("t,p,q,k", [(100, 3, 2, 128), (4096, 2, 3, 128),
                                     (4096, 3, 5, 64)])
def test_wide_tc_column_scale_on_bf16_grid_skips_only_zeros(card, t, p, q,
                                                           k):
    """Columns of {0, 1} (the samplers' scale without a normalizer): col ⊙
    δy is exact in bf16, lo is zero, and the stages it skips change no
    bit against the kernel that multiplies every lo, or δy pre-scaled."""
    dy, x, u, _, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(t, p, q, k, seed=5))
    gen = torch.Generator("cuda").manual_seed(t)
    col = (torch.rand((t,), generator=gen, device="cuda") < 0.6).float()
    ds = sigma_grad(dy, x, u, v, col)
    scaled = (dy.float() * col[:, None]).to(torch.bfloat16)
    assert torch.equal(ds, _tc_sigma_of_parts(scaled, torch.zeros_like(dy),
                                              x, u, v))
    assert torch.equal(ds, sigma_grad(scaled, x, u, v))
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v, col)) < 1e-4


@pytest.mark.parametrize("t,p,q,k", _TC + [(4096, 64, 16, 128),
                                            (300, 5, 3, 64)])
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0, "btopk"])
def test_wide_tc_feedback_matches_plain_version(card, t, p, q, k, density):
    """bf16 at k 64 and 128 on the tensor cores: dx within 2^-7 of its
    largest entry against the plain version and the plain emulation of
    the route's roundings; reruns bitwise; density 0 an exact zero."""
    dy, _, u, s, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(t, p, q, k, seed=11))
    gen = torch.Generator("cuda").manual_seed(t + p + k)
    mask = _masks(gen, q, p, density)
    before = dict(build.launch_counts)
    dx = feedback_matmul(dy, u, s, v, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["feedback_matmul_wide_tc"] \
        - before["feedback_matmul_wide_tc"] == 1
    assert build.launch_counts["feedback_matmul_wide"] \
        == before["feedback_matmul_wide"]
    assert dx.dtype == torch.bfloat16 and dx.shape == (t, q * k)
    assert torch.equal(dx, feedback_matmul(dy, u, s, v, mask))
    if density == 0.0:
        assert int(torch.count_nonzero(dx)) == 0
        return
    assert bool(torch.isfinite(dx.float()).all())
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 2 ** -7
    assert _rel(dx, ref.feedback_matmul_tc_ref(dy, u, s, v, mask)) < 2 ** -7
    # q blocks the mask keeps nowhere: exact zeros in their columns
    for qi in range(q):
        if not bool(mask[qi].any()):
            assert int(torch.count_nonzero(dx[:, qi * k:(qi + 1) * k])) == 0


def test_wide_tc_feedback_masked_q_row_is_zero(card):
    t, p, q, k = 300, 4, 3, 128
    dy, _, u, s, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(t, p, q, k, seed=13))
    mask = torch.full((q, p), 1.5, device="cuda")
    mask[1] = 0.0
    mask[2, ::2] = 0.0
    dx = feedback_matmul(dy, u, s, v, mask)
    assert int(torch.count_nonzero(dx[:, k:2 * k])) == 0
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 2 ** -7


@pytest.mark.parametrize("k", [64, 128])
def test_wide_route_still_takes_bf16_when_forced(card, k):
    dy, x, u, s, v = (a.to(torch.bfloat16)
                      for a in _sigma_inputs(129, 2, 3, k, seed=3))
    mask = _masks(torch.Generator("cuda").manual_seed(k), 3, 2, "btopk")
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v, force_route="wide")
    ds = sigma_grad(dy, x, u, v, force_route="wide")
    dx = feedback_matmul(dy, u, s, v, mask, force_route="wide")
    torch.cuda.synchronize()
    for name in ("ptc_block_matmul_wide", "sigma_grad_wide",
                 "feedback_matmul_wide"):
        assert build.launch_counts[name] - before[name] == 1, name
    for name in ("ptc_block_matmul_wide_tc", "sigma_grad_wide_tc",
                 "feedback_matmul_wide_tc"):
        assert build.launch_counts[name] == before[name], name
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < 2 ** -7
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v)) < 1e-4
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 2 ** -7


def test_wide_tc_refuses_fp32_and_other_k_on_the_card(card):
    for k, dtype in ((128, torch.float32), (100, torch.bfloat16)):
        dy, x, u, s, v = (a.to(dtype)
                          for a in _sigma_inputs(16, 2, 2, k, seed=1))
        mask = torch.ones((2, 2), device="cuda")
        with pytest.raises(ValueError, match="no route"):
            ptc_block_matmul(x, u, s, v, force_route="wide_tc")
        with pytest.raises(ValueError, match="no route"):
            sigma_grad(dy, x, u, v, force_route="wide_tc")
        with pytest.raises(ValueError, match="no route"):
            feedback_matmul(dy, u, s, v, mask, force_route="wide_tc")


# (T, P, Q, k): T at the 128-row tile's and the 32-row stage's edges; P
# or Q odd at k = 64 (a 128 × 128 tile half past P·k or Q·k)
_X3 = [(1, 2, 3, 128), (127, 3, 2, 128), (128, 2, 3, 128), (129, 3, 2, 128),
       (300, 2, 2, 128), (1, 3, 5, 64), (127, 2, 3, 64), (128, 3, 3, 64),
       (129, 5, 1, 64), (300, 3, 5, 64)]


@pytest.mark.parametrize("t,p,q,k", _X3)
@pytest.mark.parametrize("with_col", [False, True])
def test_wide_3xtf32_matches_plain_version(card, t, p, q, k, with_col):
    """fp32 at k 64 and 128 in 3xTF32: y and ds within 1e-5 of the largest
    entry of the fp32 plain versions, with and without a column scale off
    bf16's grid (its least-squares scale within 5e-4 of 1); reruns
    bitwise; the CUDA-core wide counters untouched."""
    dy, x, u, s, v = _sigma_inputs(t, p, q, k, seed=11)
    gen = torch.Generator("cuda").manual_seed(t + k)
    col = (torch.rand((t,), generator=gen, device="cuda") < 0.6).float() \
        / 0.6 if with_col else None
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v)
    ds = sigma_grad(dy, x, u, v, col)
    torch.cuda.synchronize()
    for name in ("ptc_block_matmul_wide_3xtf32", "sigma_grad_wide_3xtf32"):
        assert build.launch_counts[name] - before[name] == 1, name
    for name in ("ptc_block_matmul_wide", "sigma_grad_wide",
                 "ptc_block_matmul_wide_tc", "sigma_grad_wide_tc"):
        assert build.launch_counts[name] == before[name], name
    assert y.dtype == torch.float32 and ds.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(ds).all())
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < 1e-5
    assert _rel(y, ref.ptc_block_matmul_3xtf32_ref(x, u, s, v)) < 1e-5
    want = ref.sigma_grad_ref(dy, x, u, v, col)
    assert _rel(ds, want) < 1e-5
    assert _rel(ds, ref.sigma_grad_3xtf32_ref(dy, x, u, v, col)) < 1e-5
    if bool(want.any()):
        ratio = float((ds.double() * want.double()).sum()
                      / (want.double() ** 2).sum())
        assert abs(ratio - 1.0) < 5e-4
    else:                                # T = 1 with its column dropped
        assert not bool(ds.any())
    assert torch.equal(y, ptc_block_matmul(x, u, s, v))
    assert torch.equal(ds, sigma_grad(dy, x, u, v, col))


@pytest.mark.parametrize("k", [64, 128])
def test_wide_route_still_takes_fp32_when_forced(card, k):
    dy, x, u, s, v = _sigma_inputs(129, 2, 3, k, seed=5)
    mask = _masks(torch.Generator("cuda").manual_seed(k), 3, 2, "btopk")
    before = dict(build.launch_counts)
    y = ptc_block_matmul(x, u, s, v, force_route="wide")
    ds = sigma_grad(dy, x, u, v, force_route="wide")
    dx = feedback_matmul(dy, u, s, v, mask, force_route="wide")
    torch.cuda.synchronize()
    for name in ("ptc_block_matmul_wide", "sigma_grad_wide",
                 "feedback_matmul_wide"):
        assert build.launch_counts[name] - before[name] == 1, name
    for name in ("ptc_block_matmul_wide_3xtf32", "sigma_grad_wide_3xtf32",
                 "feedback_matmul_wide_3xtf32"):
        assert build.launch_counts[name] == before[name], name
    assert _rel(y, ref.ptc_block_matmul_ref(x, u, s, v)) < 1e-4
    assert _rel(ds, ref.sigma_grad_ref(dy, x, u, v)) < 1e-4
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 1e-4


def test_wide_3xtf32_refuses_bf16_and_other_k_on_the_card(card):
    for k, dtype in ((128, torch.bfloat16), (100, torch.float32),
                     (32, torch.float32)):
        dy, x, u, s, v = (a.to(dtype)
                          for a in _sigma_inputs(16, 2, 2, k, seed=1))
        mask = torch.ones((2, 2), device="cuda")
        with pytest.raises(ValueError, match="no route"):
            ptc_block_matmul(x, u, s, v, force_route="wide_3xtf32")
        with pytest.raises(ValueError, match="no route"):
            sigma_grad(dy, x, u, v, force_route="wide_3xtf32")
        with pytest.raises(ValueError, match="no route"):
            feedback_matmul(dy, u, s, v, mask, force_route="wide_3xtf32")


# (T, P, Q, k): T 1, 127, 129, 300 and 4096; P or Q odd (at k = 64 a
# 128-column tile half past Q·k); olmo-1b's up projection last
_X3_FB = [(1, 2, 3, 128), (127, 3, 2, 128), (129, 3, 3, 128),
          (300, 5, 1, 128), (1, 3, 5, 64), (127, 2, 3, 64), (129, 5, 3, 64),
          (300, 3, 2, 64), (4096, 4, 3, 64), (4096, 64, 16, 128)]


@pytest.mark.parametrize("t,p,q,k", _X3_FB)
@pytest.mark.parametrize("density", [0.0, 0.5, 1.0, "btopk"])
def test_wide_3xtf32_feedback_matches_plain_version(card, t, p, q, k,
                                                    density):
    """fp32 at k 64 and 128 in 3xTF32: dx within 1e-5 of the largest entry
    of the fp32 plain version and of the route's emulation; density 0 an
    exact zero; reruns bitwise; only the 3xTF32 counter moves."""
    dy, _, u, s, v = _sigma_inputs(t, p, q, k, seed=13)
    mask = _masks(torch.Generator("cuda").manual_seed(t + p + k), q, p,
                  density)
    before = dict(build.launch_counts)
    dx = feedback_matmul(dy, u, s, v, mask)
    torch.cuda.synchronize()
    assert build.launch_counts["feedback_matmul_wide_3xtf32"] \
        - before["feedback_matmul_wide_3xtf32"] == 1
    for name in ("feedback_matmul_wide", "feedback_matmul_wide_tc",
                 "feedback_matmul"):
        assert build.launch_counts[name] == before[name], name
    assert dx.dtype == torch.float32 and bool(torch.isfinite(dx).all())
    assert torch.equal(dx, feedback_matmul(dy, u, s, v, mask))
    if not bool(mask.any()):
        assert int(torch.count_nonzero(dx)) == 0
        return
    assert _rel(dx, ref.feedback_matmul_ref(dy, u, s, v, mask)) < 1e-5
    assert _rel(dx, ref.feedback_matmul_3xtf32_ref(dy, u, s, v, mask)) < 1e-5


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("row", [0, 1, 2])
def test_wide_3xtf32_feedback_masked_q_row_is_zero(card, k, row):
    """A q block that keeps no p block gives exact zeros, whichever half of
    a 128-column tile it is at k = 64, beside blocks that keep some."""
    t, p, q = 130, 4, 3
    dy, _, u, s, v = _sigma_inputs(t, p, q, k, seed=row)
    mask = _masks(torch.Generator("cuda").manual_seed(k), q, p, "btopk")
    mask[row] = 0.0
    dx = feedback_matmul(dy, u, s, v, mask)
    torch.cuda.synchronize()
    assert int(torch.count_nonzero(dx[:, row * k:(row + 1) * k])) == 0
    keep = torch.ones(q * k, dtype=torch.bool, device="cuda")
    keep[row * k:(row + 1) * k] = False
    assert _rel(dx[:, keep], ref.feedback_matmul_ref(
        dy, u, s, v, mask)[:, keep]) < 1e-5


def test_3xtf32_kernel_tile_is_the_plan(card):
    import ctypes
    out = (ctypes.c_int * 3)()
    assert tf32x3_lib().ptc_3xtf32_tile(out) == 0
    assert tuple(out) == TF32X3_TILE


def test_tc_kernel_tile_is_the_plan(card):
    import ctypes
    out = (ctypes.c_int * 3)()
    assert tc_lib().ptc_tc_tile(out) == 0
    assert tuple(out) == TC_TILE


def test_wide_kernel_tile_is_the_plan(card):
    import ctypes
    out = (ctypes.c_int * 3)()
    assert wide_lib().ptc_wide_tile(out) == 0
    assert tuple(out) == WIDE_TILE


@pytest.mark.parametrize("k", [2, 3, 4, 5, 8, 9, 13, 16, 20, 32])
@pytest.mark.parametrize("kind", ["reck", "clements"])
def test_narrow_mesh_apply_matches_plain_version(card, k, kind):
    """The narrow route's compiled patterns (k 4, 8, 9, 16, 32 exactly,
    every other k under its slot table) at 1e-5: build_unitary, rows of
    their own, one mesh over 1000 rows in both output layouts (row groups
    stored through shared memory and from registers); reruns bitwise."""
    from repro_torch.core import unitary as un
    from repro_torch.kernels import mesh_apply_plain
    from repro_torch.kernels.mesh_apply import mesh_apply_batched
    spec = un.mesh_spec(k, kind)
    gen = torch.Generator("cuda").manual_seed(k)
    ph = torch.randn((37, spec.n_rot), generator=gen, device="cuda") * 3
    d = torch.where(torch.rand((37, k), generator=gen, device="cuda") < 0.5,
                    1.0, -1.0)
    x = torch.randn((37, 5, k), generator=gen, device="cuda")
    x1 = torch.randn((1, 1000, k), generator=gen, device="cuda")
    before = build.launch_counts["mesh_apply"]
    u = un.build_unitary(spec, ph, d)
    y = mesh_apply_batched(spec, ph, x, d)
    y1 = mesh_apply_batched(spec, ph[:1], x1)
    y1t = mesh_apply_batched(spec, ph[:1], x1, transpose_out=True)
    torch.cuda.synchronize()
    assert build.launch_counts["mesh_apply"] - before == 4
    eye = torch.eye(k, device="cuda")[None]
    assert float((u - mesh_apply_plain(spec, ph, eye, d, transpose_out=True))
                 .abs().max()) < 1e-5
    assert float((y - mesh_apply_plain(spec, ph, x, d)).abs().max()) < 1e-5
    assert float((y1 - mesh_apply_plain(spec, ph[:1], x1)).abs().max()) \
        < 1e-5
    assert float((y1t - mesh_apply_plain(spec, ph[:1], x1,
                                         transpose_out=True)).abs().max()) \
        < 1e-5
    assert torch.equal(u, un.build_unitary(spec, ph, d))


@pytest.mark.parametrize("k", [33, 64, 100, 128])
@pytest.mark.parametrize("kind", ["reck", "clements"])
def test_wide_mesh_apply_matches_plain_version(card, k, kind):
    from repro_torch.core import unitary as un
    from repro_torch.kernels import mesh_apply_plain
    from repro_torch.kernels.mesh_apply import ROUTES as MESH_ROUTES
    from repro_torch.kernels.mesh_apply import mesh_apply_batched
    from repro_torch.kernels.mesh_apply import route as mesh_route
    spec = un.mesh_spec(k, kind)
    gen = torch.Generator("cuda").manual_seed(k)
    ph = torch.randn((37, spec.n_rot), generator=gen, device="cuda") * 3
    d = torch.where(torch.rand((37, k), generator=gen, device="cuda") < 0.5,
                    1.0, -1.0)
    x = torch.randn((37, 70, k), generator=gen, device="cuda")
    # k 64 and 128 take the unrolled kernel, 33 and 100 the list-driven one
    name = MESH_ROUTES[mesh_route(k)]
    assert name == ("mesh_apply_wide_unrolled" if k in (64, 128)
                    else "mesh_apply_wide")
    before = dict(build.launch_counts)
    u = un.build_unitary(spec, ph, d)
    y = mesh_apply_batched(spec, ph, x, d)
    torch.cuda.synchronize()
    assert build.launch_counts[name] - before[name] == 2
    for other in ("mesh_apply", "mesh_apply_wide",
                  "mesh_apply_wide_unrolled"):
        if other != name:
            assert build.launch_counts[other] == before[other], other
    eye = torch.eye(k, device="cuda")[None]
    assert float((u - mesh_apply_plain(spec, ph, eye, d, transpose_out=True))
                 .abs().max()) < 1e-5
    assert float((y - mesh_apply_plain(spec, ph, x, d)).abs().max()) < 1e-5
    assert torch.equal(y, mesh_apply_batched(spec, ph, x, d))


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("kind", ["reck", "clements"])
@pytest.mark.parametrize("signs", [True, False])
def test_unrolled_mesh_apply_matches_plain_version(card, k, kind, signs):
    """The unrolled kernel at k 64 and 128: build_unitary (U U^T - I below
    1e-4), rows of their own, one mesh over 1000 rows (8 or 16 row groups)
    in both output layouts, with signs d and without: 1e-5; reruns
    bitwise; the list-driven kernel forced on the same inputs agrees."""
    from repro_torch.core import unitary as un
    from repro_torch.kernels import mesh_apply_plain
    from repro_torch.kernels.mesh_apply import mesh_apply_batched
    spec = un.mesh_spec(k, kind)
    gen = torch.Generator("cuda").manual_seed(k + signs)
    ph = torch.rand((19, spec.n_rot), generator=gen, device="cuda") \
        * 4 * torch.pi
    d = torch.where(torch.rand((19, k), generator=gen, device="cuda") < 0.5,
                    1.0, -1.0) if signs else None
    x = torch.randn((19, 3, k), generator=gen, device="cuda")
    x1 = torch.randn((1, 1000, k), generator=gen, device="cuda")
    before = dict(build.launch_counts)
    u = un.build_unitary(spec, ph, d)
    y = mesh_apply_batched(spec, ph, x, d)
    y1 = mesh_apply_batched(spec, ph[:1], x1)
    y1t = mesh_apply_batched(spec, ph[:1], x1, transpose_out=True)
    torch.cuda.synchronize()
    assert build.launch_counts["mesh_apply_wide_unrolled"] \
        - before["mesh_apply_wide_unrolled"] == 4
    assert build.launch_counts["mesh_apply_wide"] == before["mesh_apply_wide"]
    eye = torch.eye(k, device="cuda")[None]
    want_u = mesh_apply_plain(spec, ph, eye, d, transpose_out=True)
    assert float((u - want_u).abs().max()) < 1e-5
    assert float((u @ u.transpose(1, 2) - eye).abs().max()) < 1e-4
    assert float((y - mesh_apply_plain(spec, ph, x, d)).abs().max()) < 1e-5
    assert float((y1 - mesh_apply_plain(spec, ph[:1], x1)).abs().max()) \
        < 1e-5
    assert float((y1t - mesh_apply_plain(spec, ph[:1], x1,
                                         transpose_out=True)).abs().max()) \
        < 1e-5
    assert torch.equal(u, un.build_unitary(spec, ph, d))
    forced = mesh_apply_batched(spec, ph, eye, d, transpose_out=True,
                                force_route="wide")
    torch.cuda.synchronize()
    assert build.launch_counts["mesh_apply_wide"] \
        - before["mesh_apply_wide"] == 1
    assert float((forced - u).abs().max()) < 1e-5


_CC_PREFILL = [(3, 5, 4, 2, 8, 24, [0, 7, 19]),       # the reference test
               (2, 37, 3, 3, 96, 136, [0, 99]),        # rep 1, 37 rows
               (2, 50, 4, 2, 128, 640, [0, 590])]      # lens = S - C


@pytest.mark.parametrize("geom", _CC_PREFILL)
@pytest.mark.parametrize("blk", [None, 8, 4])
@pytest.mark.parametrize("window,cap", [(None, None), (6, None), (None, 3.0),
                                        (5, 2.0)])
def test_cuda_core_prefill_matches_plain_version(card, geom, blk, window,
                                                 cap):
    lens, q, k, v = _bf16_inputs(geom, seed=3)
    q, k, v = q.float(), k.float(), v.float()
    kw = dict(blk=blk, window=window, cap=cap)
    before = dict(build.launch_counts)
    got = prefill_attention(lens, q, k, v, **kw)
    mixed = prefill_attention(lens, q, k.bfloat16(), v.bfloat16(), **kw)
    torch.cuda.synchronize()
    assert build.launch_counts[NAME_CUDA_CORES] \
        - before[NAME_CUDA_CORES] == 2
    assert build.launch_counts[NAME] == before[NAME]
    assert torch.equal(got, prefill_attention(lens, q, k, v, **kw))
    want = ref.prefill_attention_ref(lens, q, k, v, window=window, cap=cap)
    assert float((got - want).abs().max()) < 2e-5
    want = ref.prefill_attention_ref(lens, q, k.bfloat16(), v.bfloat16(),
                                     window=window, cap=cap)
    assert float((mixed - want).abs().max()) < 2e-5


@pytest.mark.parametrize("hd", [5, 96, 200, 256])
def test_cuda_core_prefill_takes_other_head_dims(card, hd):
    lens, q, k, v = _bf16_inputs((2, 9, 4, 2, hd, 100, [0, 91]), seed=4)
    got = prefill_attention(lens, q, k, v, window=40)   # bf16, not 64/128
    assert _rel(got, ref.prefill_attention_ref(lens, q, k, v,
                                               window=40)) <= 2 ** -7
    q, k, v = q.float(), k.float(), v.float()
    got = prefill_attention(lens, q, k, v, window=40)
    assert float((got - ref.prefill_attention_ref(lens, q, k, v, window=40))
                 .abs().max()) < 2e-5


@pytest.mark.parametrize("blk", [1, 4, 8, 24, 32, 40, 64, 640])
@pytest.mark.parametrize("hd", [128, 200])      # 64-key and 32-key tiles
def test_cuda_core_prefill_is_the_same_at_every_block(card, blk, hd):
    # the kernel reads no blk: every block gives the whole view's bits
    lens, q, k, v = _bf16_inputs((2, 20, 4, 2, hd, 1920, [0, 1900]), seed=6)
    q, k, v = q.float(), k.float(), v.float()
    whole = prefill_attention(lens, q, k, v, window=700)
    assert torch.equal(prefill_attention(lens, q, k, v, blk=blk, window=700),
                       whole)


def test_cuda_core_prefill_block_outside_the_window_changes_no_bit(card):
    lens, q, k, v = _bf16_inputs((1, 8, 4, 2, 32, 200, [160]), seed=5)
    q, k, v = q.float(), k.float(), v.float()
    base = prefill_attention(lens, q, k, v, window=20)
    k2, v2 = k.clone(), v.clone()
    # keys 0-140 lie before every query's window (keys > 140): tiles 0 and
    # 1 skipped, tile 2 masked inside a live tile
    k2[:, :141], v2[:, :141] = 999.0, -999.0
    assert torch.equal(base, prefill_attention(lens, q, k2, v2, window=20))
