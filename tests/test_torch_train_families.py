"""Port parity: the training step of the other families — whisper-base
(encdec), llama-3.2-vision-11b (vlm), qwen3-moe-30b-a3b (MoE) and
falcon-mamba-7b (ssm) — and the port's own ``lm.inject_masks``, against
the reference on the CPU.

The reference's masks are drawn once and handed to both packages, as in
``test_torch_train_step.py``; the port's ``inject_masks`` is checked by
structure: which leaves get masks, their shapes and lead axes (one mask
per period and expert), and the keep counts per row.

* loss and every trainable gradient leaf within 1e-5 (fp32): whisper-base
  blocked with α_W = α_C = 0.6 (its cross-attention K/V read the encoder's
  B·S rows, so column sampling applies), llama-3.2-vision-11b blocked with
  α_W = 0.6, qwen3-moe-30b-a3b fused with α_W = 0.6 (each expert through
  the in-situ backward), falcon-mamba-7b blocked with α_W = α_C = 0.6;
* vlm with α_C < 1 fails in both packages: the reference gives every PTC
  leaf a column mask of B·S tokens, and the cross-attention's K/V read
  B·n_img rows;
* the port's ``inject_masks``: the reference's leaves and shapes,
  ``round(α·P)`` kept blocks in every feedback row scaled by 1/α,
  ``round(α·T)`` kept tokens in every column mask, one draw per stacked
  entry.
"""

import jax
import pytest
import torch

from _torch_lm_util import B, S, at, lm_inputs, model, split_batch
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.models import lm as jlm
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.models import lm as tlm
from test_torch_train_step import TOL, _check_grads, _masks_only, _train_steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [
    ("whisper-base", "blocked", 0.6, 0.6),
    ("llama-3.2-vision-11b", "blocked", 0.6, 1.0),
    ("qwen3-moe-30b-a3b", "fused", 0.6, 1.0),
    ("falcon-mamba-7b", "blocked", 0.6, 0.6),
]


@pytest.mark.parametrize("name,mode,alpha_w,alpha_c", CASES)
def test_family_train_step_matches_reference(monkeypatch, name, mode,
                                             alpha_w, alpha_c):
    _check_grads(*_train_steps(monkeypatch, name, mode, alpha_w, alpha_c),
                 TOL)


@pytest.mark.parametrize("mode", ["fused", "blocked"])
def test_vlm_column_sampling_fails_in_both(mode):
    """The reference gives every PTC leaf a column mask of B·S tokens, but
    the cross-attention's K/V read B·n_img rows: its train step fails, and
    the port's raises a ValueError saying so."""
    jc, tc, jp, tp = model("llama-3.2-vision-11b", mode)
    jb, tb = split_batch(lm_inputs(jc, seed=2))
    with pytest.raises(Exception):
        jlm.build_train_step(jc, JSparsity(alpha_c=0.6))(
            jp, jb, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="column mask has .* rows"):
        tlm.build_train_step(tc, SparsityConfig(alpha_c=0.6))(
            tp, tb, torch.Generator().manual_seed(0))
    # feedback sampling alone works in both
    tlm.build_train_step(tc, SparsityConfig(alpha_w=0.6))(
        tp, tb, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-moe-30b-a3b",
                                  "whisper-base"])
def test_inject_masks_structure(name):
    """The port's masks sit where the reference's do, with the same shapes
    (a stacked lead axis per period / expert), ``round(α·P)`` kept blocks
    in every feedback row scaled by 1/α (``exp``), and ``round(α·T)``
    kept tokens in every column mask."""
    jc, tc, jp, tp = model(name)
    jscfg = JSparsity(alpha_w=0.6, alpha_c=0.6)
    want = _masks_only(jlm.inject_masks(jp, jax.random.PRNGKey(1), jscfg,
                                        B * S))
    got = _masks_only(tlm.inject_masks(
        tp, torch.Generator().manual_seed(1),
        SparsityConfig(alpha_w=0.6, alpha_c=0.6), B * S))
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(wl) == len(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in wl:
        g = at(got, path)
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        if path[-1].key == "fb":
            p = g.shape[-1]
            keep = max(1, round(0.6 * p))
            rows = (g > 0).sum(-1)
            assert bool((rows == keep).all())
            assert torch.allclose(g[g > 0], torch.tensor(p / keep))
        else:
            keep = round(0.6 * B * S)
            assert bool(((g > 0).sum(-1) == keep).all())
            assert set(g.unique().tolist()) <= {0.0, 1.0}
    # the masks differ between stacked entries (one draw each)
    fb = got["pos0"]["attn"]["wq"]["fb"]
    assert not torch.equal(fb[0], fb[1])
    # disabled sampling leaves the tree as it is
    assert tlm.inject_masks(tp, None, SparsityConfig(), B * S) is tp
