"""Port parity: ``repro_torch.core.sparsity`` against ``repro.core.sparsity``.

The reference samples with ``jax.random``; the port's samplers take the
same draw injected (``noise=``, ``idx=``, ``u=``), so every mask must equal
the reference's exactly, values and normalizers included.  Under the
suite's x64 setting the reference's uniform draws are float64; they are
handed to the port as they are, and both sides rank the same float64
values.  Ties go to the lowest index on both sides, checked on scores
with exact ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparsity as jsp
from repro_torch.core import sparsity as tsp

P, Q = 7, 5


def _energy(seed):
    s = np.random.default_rng(seed).standard_normal((P, Q, 9)).astype(
        np.float32)
    return (s * s).sum(-1)


def _jax_noise(key, mode):
    if mode == "uniform":
        return jax.random.uniform(key, (Q, P))
    return jax.random.uniform(key, (Q, P), minval=1e-20, maxval=1.0)


@pytest.mark.parametrize("mode", ["uniform", "topk", "btopk"])
@pytest.mark.parametrize("norm", ["none", "exp", "var"])
@pytest.mark.parametrize("alpha", [0.3, 0.6])
def test_feedback_mask_matches_reference(mode, norm, alpha):
    cfg_j = jsp.SparsityConfig(alpha_w=alpha, feedback_mode=mode,
                               feedback_norm=norm)
    cfg_t = tsp.SparsityConfig(alpha_w=alpha, feedback_mode=mode,
                               feedback_norm=norm)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        energy = _energy(seed)
        mj = np.asarray(jsp.feedback_mask(key, jnp.asarray(energy), cfg_j))
        noise = torch.from_numpy(np.array(_jax_noise(key, mode)))
        mt = tsp.feedback_mask(None, torch.from_numpy(energy), cfg_t,
                               noise=None if mode == "topk" else noise)
        assert mt.dtype == torch.float32 and mt.shape == (Q, P)
        np.testing.assert_array_equal(mt.numpy(), mj)


def test_dense_feedback_mask_is_ones():
    mt = tsp.feedback_mask(None, torch.ones(P, Q), tsp.DENSE)
    assert torch.equal(mt, torch.ones(Q, P))


@pytest.mark.parametrize("keep", [1, 3, 6])
def test_row_balanced_topk_ties_go_to_the_lowest_index(keep):
    scores = np.array([[1, 3, 3, 2, 3, 1, 3],
                       [0, 0, 0, 0, 0, 0, 0],
                       [5, 4, 5, 4, 5, 4, 5]], np.float32)
    mj = np.asarray(jsp._row_balanced_topk(jnp.asarray(scores), keep))
    mt = tsp._row_balanced_topk(torch.from_numpy(scores), keep).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert (mt.sum(-1) == keep).all()


def test_topk_feedback_mask_with_exact_ties():
    energy = np.repeat(np.array([[2.0], [1.0], [2.0], [0.5], [1.0], [2.0],
                                 [1.0]], np.float32), Q, axis=1)
    for alpha in (0.2, 0.5, 0.7):
        cfg_j = jsp.SparsityConfig(alpha_w=alpha, feedback_mode="topk")
        cfg_t = tsp.SparsityConfig(alpha_w=alpha, feedback_mode="topk")
        mj = np.asarray(jsp.feedback_mask(jax.random.PRNGKey(0),
                                          jnp.asarray(energy), cfg_j))
        mt = tsp.feedback_mask(None, torch.from_numpy(energy), cfg_t)
        np.testing.assert_array_equal(mt.numpy(), mj)


def test_btopk_is_row_balanced_from_the_generator():
    cfg = tsp.SparsityConfig(alpha_w=0.6)
    gen = torch.Generator().manual_seed(0)
    energy = torch.from_numpy(_energy(0))
    masks = [tsp.feedback_mask(gen, energy, cfg) for _ in range(4)]
    keep = round(0.6 * P)
    for m in masks:
        assert torch.equal(tsp.accumulation_depths(m),
                           torch.full((Q,), keep))
        assert set(m.unique().tolist()) == {0.0, P / keep}
    assert not all(torch.equal(masks[0], m) for m in masks[1:])
    again = tsp.feedback_mask(torch.Generator().manual_seed(0), energy, cfg)
    assert torch.equal(again, masks[0])


@pytest.mark.parametrize("norm", ["none", "exp", "var"])
@pytest.mark.parametrize("alpha,n_cols", [(0.6, 50), (0.25, 37), (1.0, 10)])
def test_column_mask_matches_reference(norm, alpha, n_cols):
    cfg_j = jsp.SparsityConfig(alpha_c=alpha, column_norm=norm)
    cfg_t = tsp.SparsityConfig(alpha_c=alpha, column_norm=norm)
    key = jax.random.PRNGKey(7)
    mj = np.asarray(jsp.column_mask(key, n_cols, cfg_j))
    keep = max(1, int(round(alpha * n_cols)))
    idx = torch.from_numpy(np.array(
        jax.random.choice(key, n_cols, (keep,), replace=False)))
    mt = tsp.column_mask(None, n_cols, cfg_t, idx=idx)
    np.testing.assert_array_equal(mt.numpy(), mj)
    assert int((mt > 0).sum()) == keep
    scale = cfg_t.normalizer(keep / n_cols, norm)
    assert set(mt.unique().tolist()) <= {0.0, np.float32(scale)}
    drawn = tsp.column_mask(torch.Generator().manual_seed(1), n_cols, cfg_t)
    assert int((drawn > 0).sum()) == keep


def test_column_mask_rejects_a_wrong_draw():
    cfg = tsp.SparsityConfig(alpha_c=0.5)
    with pytest.raises(ValueError):
        tsp.column_mask(None, 10, cfg, idx=torch.arange(4))


@pytest.mark.parametrize("alpha_d", [0.0, 0.2, 0.7])
def test_smd_keep_iteration_matches_reference(alpha_d):
    cfg_j = jsp.SparsityConfig(alpha_d=alpha_d)
    cfg_t = tsp.SparsityConfig(alpha_d=alpha_d)
    for seed in range(20):
        key = jax.random.PRNGKey(seed)
        kj = bool(jsp.smd_keep_iteration(key, cfg_j))
        kt = tsp.smd_keep_iteration(
            None, cfg_t, u=float(jax.random.uniform(key, ())))
        assert kt == kj
    gen = torch.Generator().manual_seed(0)
    kept = sum(tsp.smd_keep_iteration(gen, cfg_t) for _ in range(2000))
    assert abs(kept / 2000 - (1 - alpha_d)) < 0.05


def test_accumulation_depths_match_reference():
    m = (np.random.default_rng(3).random((Q, P)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        tsp.accumulation_depths(torch.from_numpy(m)).numpy(),
        np.asarray(jsp.accumulation_depths(jnp.asarray(m))))


@pytest.mark.parametrize("alpha,kind", [(0.5, "exp"), (0.5, "var"),
                                        (0.3, "none"), (1.0, "exp")])
def test_normalizer_matches_reference(alpha, kind):
    assert tsp.SparsityConfig().normalizer(alpha, kind) == \
        jsp.SparsityConfig().normalizer(alpha, kind)
