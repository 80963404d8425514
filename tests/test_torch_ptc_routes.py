"""The PTC kernels' launch rules, and their plain versions at the new shapes.

* ``ptc_block_matmul.route``: the IC/PM probe geometry (Q = 1, T = k)
  takes the per-block route, serve, the convolutions and FC at T = 32 the
  product route, and the crossover sits at ``PER_BLOCK_MAX_T``.
* Every k > 32 goes to the wide route of all four kernels, at every T
  and Q (the per-block route never takes it; the mesh's k = 64 and 128 its
  unrolled wide kernel), and ``kernel_k`` names k itself there; the wide plan's 128 × 128 tiles cover every row, every
  output column and every block's rows and columns exactly once, for the
  forward (T, P·k), the feedback (T, Q·k) and the Σ-gradient's G
  (P·k, Q·k).
* ``ptc_block_matmul.plan`` and ``sigma_grad.plan`` (pure functions of the
  shapes): the tiles and splits they launch cover every row, every output
  block and every reduction column exactly once, and the splits appear
  only where the tiles cannot fill the card.
* The plain versions (which the wrappers run on CPU tensors) against
  ``repro.kernels.ops`` in interpret mode at small copies of the geometries
  the new kernels special-case: a probe-like (9, 64, 1, 9), and P·k or Q·k
  of 27, 135 and 513 (rows that are not 16-byte aligned), both sides in
  float32 under the suite's x64 setting; tolerances as
  ``tests/test_torch_kernels_ref.py`` (1e-4 relative fp32, 6e-2 bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import build, ptc_block_matmul, sigma_grad
from repro_torch.kernels.feedback_matmul import route as feedback_route
from repro_torch.kernels.mesh_apply import route as mesh_route
from repro_torch.kernels.ptc_block_matmul import (K_STAGE, MAX_K,
                                                  PER_BLOCK_MAX_T, ROUTES,
                                                  WIDE_TILE, kernel_k, route,
                                                  wide_plan)
from repro_torch.kernels.ptc_block_matmul import plan as product_plan
from repro_torch.kernels.sigma_grad import plan as sigma_plan
from repro_torch.kernels.sigma_grad import route as sigma_route

# (T, P, Q, k): the shapes the port's paths give the two kernels
SERVE_W1 = (1024, 57, 456, 9)
PROBE = (9, 25992, 1, 9)
VGG8 = {"conv0": (32768, 8, 3, 9), "conv1": (32768, 8, 64, 9),
        "conv2": (8192, 15, 64, 9), "conv3": (8192, 15, 128, 9),
        "conv4": (2048, 29, 128, 9), "conv5": (2048, 29, 256, 9),
        "fc1": (32, 57, 456, 9), "fc2": (32, 2, 57, 9)}
PLAN_SHAPES = [SERVE_W1, PROBE, *VGG8.values(), (1000, 3, 5, 13),
               (37, 2, 3, 13), (64, 4, 4, 16), (128, 2, 2, 32),
               (16, 3, 2, 4), (8, 2, 3, 8), (1, 1, 1, 1), (255, 9, 17, 9),
               (257, 9, 17, 9)]


def _intervals(n, size, count=None):
    """[start, stop) of each tile of ``size`` over n, as a launch grid of
    ``count`` (default ceil(n / size)) tiles cuts it."""
    count = -(-n // size) if count is None else count
    return [(i * size, min(n, (i + 1) * size)) for i in range(count)]


def _assert_partition(spans, n):
    """The spans are non-empty, in order and cover [0, n) exactly once."""
    assert spans and spans[0][0] == 0 and spans[-1][1] == n
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b == c
    assert all(a < b for a, b in spans)


@pytest.mark.parametrize("shape", [PROBE, (9, 64, 1, 9), (9, 2, 1, 9),
                                   (4, 1000, 1, 4),
                                   (PER_BLOCK_MAX_T, 5, 1, 9)])
def test_probe_geometry_takes_the_per_block_route(shape):
    assert route(*shape) == "per_block"


@pytest.mark.parametrize("name", sorted(VGG8))
def test_vgg8_layers_take_the_product_route(name):
    assert route(*VGG8[name]) == "product"


@pytest.mark.parametrize("shape", [SERVE_W1, (1024, 2, 57, 9), (9, 2, 2, 9),
                                   (PER_BLOCK_MAX_T + 1, 5, 1, 9),
                                   (1024, 25992, 1, 9)])
def test_serve_and_wide_inputs_take_the_product_route(shape):
    assert route(*shape) == "product"


@pytest.mark.parametrize("k", [33, 64, 100, 128, 256])
@pytest.mark.parametrize("t", [1, 9, PER_BLOCK_MAX_T, PER_BLOCK_MAX_T + 1,
                               4096])
@pytest.mark.parametrize("q", [1, 16])
def test_every_wide_k_takes_the_wide_route(k, t, q):
    assert route(t, 64, q, k) == "wide"
    assert sigma_route(k) == feedback_route(k) == "wide"
    # the mesh's k = 64 and 128 take its unrolled wide kernel
    assert mesh_route(k) == ("wide_unrolled" if k in (64, 128) else "wide")
    assert kernel_k(k) == k


@pytest.mark.parametrize("k", [1, 4, 9, 13, 16, 32])
def test_no_k_up_to_32_takes_the_wide_route(k):
    assert MAX_K == 32
    for t, q in ((9, 1), (4096, 16)):
        assert route(t, 64, q, k) != "wide"
    assert sigma_route(k) == feedback_route(k) == mesh_route(k) == "narrow"
    assert kernel_k(k) in (4, 8, 9, 16, 32) and kernel_k(k) >= k


# (T, P, Q, k): olmo-1b's linears at k = 128 (q/k/v/o, gate/up, down), the
# widths and ragged T of the card tests
WIDE_SHAPES = [(4096, 16, 16, 128), (4096, 64, 16, 128), (4096, 16, 64, 128),
               (37, 2, 3, 33), (64, 2, 2, 64), (129, 3, 2, 100),
               (127, 3, 3, 128), (1, 1, 1, 128), (300, 2, 3, 256)]


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_wide_plan_covers_rows_columns_and_blocks_once(shape):
    t, p, q, k = shape
    bm, bn, _ = WIDE_TILE
    for rows, cols in ((t, p * k), (t, q * k), (p * k, q * k)):
        pl = wide_plan(rows, cols, k)
        _assert_partition(_intervals(rows, bm, pl.row_tiles), rows)
        _assert_partition(_intervals(cols, bn, pl.col_tiles), cols)
        # each block's k rows and k columns, in the batched block products
        _assert_partition(_intervals(k, bm, pl.block_tiles), k)
        _assert_partition(_intervals(k, bn, pl.block_tiles), k)
    # at k = 128 a product tile is one block: the tile edges are block edges
    if k == 128:
        assert wide_plan(t, p * k, k).col_tiles == p
        assert wide_plan(p * k, q * k, k)[:2] == (p, q)


def test_each_route_counts_under_its_own_name_in_one_library():
    assert ROUTES == {"product": "ptc_block_matmul",
                      "per_block": "ptc_block_matmul_perblock",
                      "wide": "ptc_block_matmul_wide",
                      "wide_tc": "ptc_block_matmul_wide_tc",
                      "wide_3xtf32": "ptc_block_matmul_wide_3xtf32"}
    for name in ROUTES.values():
        # the k <= 32 routes share one library; the wide routes of the
        # three PTC kernels share another, the bf16 tensor-core routes a
        # third, the 3xTF32 routes a fourth
        assert build.KERNELS[name] == (
            "ptc_wide" if name.endswith("_wide") else
            "ptc_wide_tc" if name.endswith("_wide_tc") else
            "ptc_wide_3xtf32" if name.endswith("_wide_3xtf32") else
            "ptc_block_matmul")
        assert name in build.launch_counts


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_product_plan_covers_rows_blocks_and_columns_once(shape):
    t, p, q, k = shape
    pl = product_plan(t, p, q, k)
    assert pl.kt == kernel_k(k) and pl.kp % 4 == 0 and pl.kp >= k
    assert pl.bm * pl.wn == 256
    assert pl.nblk == pl.wn * {4: 8, 8: 8, 9: 8, 16: 4, 32: 2}[pl.kt]
    assert pl.kc % K_STAGE == 0
    _assert_partition(_intervals(t, pl.bm), t)
    _assert_partition(_intervals(p, pl.nblk), p)
    # the K splits: none empty, the last ends at Q·k
    _assert_partition(_intervals(q * k, pl.kc, pl.splits), q * k)


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_sigma_plan_covers_rows_and_blocks_once(shape):
    t, p, q, k = shape
    pl = sigma_plan(t, p, q, k)
    assert pl.kt == kernel_k(k) and pl.chunk_rows % 16 == 0
    _assert_partition(_intervals(t, pl.chunk_rows, pl.splits), t)
    _assert_partition(_intervals(p, pl.mp), p)
    _assert_partition(_intervals(q, pl.nq), q)
    # a tile is mp·k' × nq·k' of G with k' the compiled k: 72 × 144 at 9
    if pl.kt == 9:
        assert (pl.mp * 9, pl.nq * 9) == (72, 144)


def test_product_plan_splits_only_where_tiles_leave_sms_idle():
    # serve W1: 8 × 4 tiles of 128 rows × 16 blocks → K split, about one
    # CTA per SM
    pl = product_plan(*SERVE_W1)
    assert (pl.wn, pl.bm, pl.nblk) == (2, 128, 16)
    assert pl.splits > 1 and 32 * pl.splits <= 132
    # P = 8 convolutions: 256 rows × 8 blocks, 128 tiles, no split
    for name in ("conv0", "conv1"):
        pl = product_plan(*VGG8[name])
        assert (pl.wn, pl.bm, pl.nblk, pl.splits) == (1, 256, 8, 1)
    # FC W1 at batch 32: 4 tiles, the Q reduction split across CTAs
    assert product_plan(*VGG8["fc1"]).splits >= 33
    # a card with more SMs splits no less
    assert product_plan(*SERVE_W1, sms=264).splits >= product_plan(*SERVE_W1).splits


def test_sigma_plan_splits_t_only_where_tiles_leave_sms_idle():
    assert sigma_plan(1024, 57, 456, 9).splits == 1        # 232 tiles
    conv1 = sigma_plan(*VGG8["conv1"])                      # 4 tiles
    assert conv1.splits >= 33 and conv1.chunk_rows >= 256
    assert sigma_plan(*VGG8["fc2"]).splits == 1             # 32 rows


def test_plans_reject_k_past_the_widest_kernel():
    for fn in (product_plan, sigma_plan):
        with pytest.raises(ValueError):
            fn(64, 2, 2, 33)
        with pytest.raises(ValueError):
            fn(64, 2, 2, 0)


def test_wrappers_refuse_a_route_or_device_they_cannot_serve():
    x, u, s, v = (torch.zeros(shape) for shape in
                  ((4, 18), (2, 2, 9, 9), (2, 2, 9), (2, 2, 9, 9)))
    meta = [a.to("meta") for a in (x, u, s, v)]
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        ptc_block_matmul(*meta, force_route="per_block")
    with pytest.raises(ValueError):
        sigma_grad(torch.zeros(4, 18).to("meta"), meta[0], meta[1], meta[3])


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# small copies of the new geometries: (T, P, Q, k)
NEW_GEOMETRIES = [(9, 64, 1, 9),      # probe-like: Q = 1, T = k
                  (16, 3, 3, 9),      # Q·k = 27 (VGG-8 conv0's input)
                  (20, 15, 3, 9),     # P·k = 135 (conv2/3's output)
                  (12, 57, 2, 9),     # P·k = 513 (FC W1's output)
                  (10, 2, 57, 9)]     # Q·k = 513 (FC 512 -> 10's input)


@pytest.mark.parametrize("t,p,q,k", NEW_GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ptc_plain_matches_reference_at_new_geometries(t, p, q, k, dtype):
    arrs = _arrays(t * 1000 + p * 10 + q, (t, q * k), (p, q, k, k),
                   (p, q, k), (p, q, k, k))
    yj = ops.ptc_block_matmul(*(jnp.asarray(a, dtype) for a in arrs))
    yj = np.asarray(yj.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    before = dict(build.launch_counts)
    yt = ptc_block_matmul(*(torch.from_numpy(a).to(tdt) for a in arrs))
    assert build.launch_counts == before     # the plain path launches nothing
    assert yt.shape == (t, p * k) and yt.dtype == tdt
    err = np.abs(yt.float().numpy() - yj).max() / (np.abs(yj).max() + 1e-6)
    assert err < (1e-4 if dtype == "float32" else 6e-2), err


@pytest.mark.parametrize("t,p,q,k", NEW_GEOMETRIES)
def test_sigma_grad_plain_matches_reference_at_new_geometries(t, p, q, k):
    dy, x, u, v = _arrays(t + 7 * p + q, (t, p * k), (t, q * k),
                          (p, q, k, k), (p, q, k, k))
    dsj = np.asarray(ops.sigma_grad(*(jnp.asarray(a, jnp.float32)
                                      for a in (dy, x, u, v))))
    dst = sigma_grad(*(torch.from_numpy(a) for a in (dy, x, u, v)))
    assert dst.shape == (p, q, k) and dst.dtype == torch.float32
    scale = np.abs(dsj).max() + 1e-6
    assert np.abs(dst.numpy() - dsj.astype(np.float32)).max() / scale < 1e-4
