"""Port parity: ``repro_torch.models.cnn`` (and the PTC linear of
``models.layers``) against ``repro.models.cnn``.

Parameters are made with numpy from a seed, in the shapes ``init_cnn``
gives (Haar-random bases, Glorot-scaled Σ, non-zero biases), and carried
to both packages (``convert.param_tree`` for the port); inputs are
float32 numpy on both sides.  The reference's ``init_cnn`` itself is not
called: its eager batched QR takes tens of seconds on a CPU.

* im2col: exact feature order (C, KH, KW), at stride 1 and at stride 2
  with SAME padding on an even size (the odd pad row goes after), 1e-6.
* logits of MLP-Vowel, CNN-S and VGG-8 at batch 2: 1e-4 relative to the
  largest logit (blocked PTC sums in another order).
* every Σ and bias gradient of a dense step, and of a sampled step with
  the reference's masks handed over: 1e-4 relative to the largest entry.
* a sampled MLP-Vowel run learns, as ``tests/test_cnn.py`` checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import synthetic_vision
from repro_torch.models import cnn as tcnn
from repro_torch.models.layers import trainable_mask
from repro_torch.optim.optimizers import (AdamWConfig, apply_updates,
                                          init_opt_state)

CONFIGS = {"mlp-vowel": (jcnn.MLP_VOWEL, tcnn.MLP_VOWEL),
           "cnn-s": (jcnn.CNN_S, tcnn.CNN_S),
           "vgg8": (jcnn.VGG8, tcnn.VGG8)}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-12)


@pytest.mark.parametrize("shape,ksize,stride,pad", [
    ((2, 8, 8, 3), 3, 1, "SAME"), ((2, 8, 8, 3), 3, 2, "SAME"),
    ((1, 28, 28, 1), 3, 2, "SAME"), ((2, 7, 7, 2), 3, 2, "SAME"),
    ((2, 9, 9, 2), 3, 2, "VALID")])
def test_im2col_matches_reference(shape, ksize, stride, pad):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jcnn._im2col(jnp.asarray(x), ksize, stride, pad))
    got = tcnn._im2col(torch.from_numpy(x), ksize, stride, pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_im2col_feature_order_is_channel_major():
    """Patch features run (C, KH, KW): a conv through im2col equals
    ``F.conv2d`` with the kernel flattened channel-major."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 3, 3, 3)).astype(np.float32))
    cols = tcnn._im2col(x, 3, 1, "SAME")
    out = cols.reshape(-1, 27) @ w.reshape(5, 27).T
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    np.testing.assert_allclose(out.reshape(2, 8, 8, 5).numpy(),
                               want.permute(0, 2, 3, 1).numpy(), atol=1e-5)


# (d_in, d_out) of VGG-8's PTC layers (src/repro/models/cnn.py:67-71)
VGG8_WIDTHS = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
               (2304, 256), (4096, 512), (512, 10)]


def test_init_shapes_follow_the_reference_widths():
    params = tcnn.init_cnn(torch.Generator().manual_seed(0), tcnn.VGG8)
    assert list(params) == ["l0", "l1", "l3", "l4", "l6", "l7", "l9", "l10"]
    for layer, (d_in, d_out) in zip(params.values(), VGG8_WIDTHS):
        p, q = -(-d_out // 9), -(-d_in // 9)
        assert layer["u"].shape == layer["v"].shape == (p, q, 9, 9)
        assert layer["s"].shape == (p, q, 9) and layer["b"].shape == (d_out,)
        assert all(a.dtype == torch.float32 for a in layer.values())
        eye = torch.eye(9).expand(p, q, 9, 9)
        assert torch.allclose(layer["u"] @ layer["u"].transpose(-1, -2), eye,
                              atol=1e-5)


def _params(ct, seed):
    """numpy parameters in the shapes of ``init_cnn``."""
    rng = np.random.default_rng(seed)
    tree = {}
    shapes = tcnn.init_cnn(torch.Generator().manual_seed(0), ct)
    for name, layer in shapes.items():
        p, q, k, _ = layer["u"].shape
        d_out = layer["b"].shape[0]
        u, v = (np.linalg.qr(rng.standard_normal((p, q, k, k)))[0]
                for _ in range(2))
        s = rng.standard_normal((p, q, k)) * np.sqrt(2 * k / (d_out + q * k))
        b = rng.standard_normal(d_out) * 0.1
        tree[name] = {n: a.astype(np.float32)
                      for n, a in dict(u=u, s=s, v=v, b=b).items()}
    return tree


def _setup(name, batch=2, seed=0):
    cj, ct = CONFIGS[name]
    tree = _params(ct, seed)
    pj = jax.tree.map(jnp.asarray, tree)
    d = synthetic_vision(seed, 0, batch, ct.in_shape, ct.n_classes)
    return cj, ct, pj, convert.param_tree(tree), d


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    cj, ct, pj, pt, d = _setup(name)
    want = jax.jit(lambda p, x: jcnn.cnn_forward(p, cj, x))(
        pj, jnp.asarray(d["x"]))
    got = tcnn.cnn_forward(pt, ct, torch.from_numpy(d["x"]))
    assert tuple(got.shape) == (2, ct.n_classes)
    assert _rel(got.detach(), want) < 1e-4


def _check_grads(gt, gj, pt):
    tr = trainable_mask(pt)
    assert {(n, l) for n in gt for l in gt[n]} == \
        {(n, l) for n in tr for l in tr[n] if tr[n][l]}
    for name, leaves in gt.items():
        for leaf, g in leaves.items():
            assert leaf in ("s", "b")
            assert _rel(g, gj[name][leaf]) < 1e-4, (name, leaf)


@pytest.mark.parametrize("name", ["mlp-vowel", "cnn-s"])
def test_dense_gradients_match_reference(name):
    cj, ct, pj, pt, d = _setup(name, batch=4)
    lj, gj = jax.jit(jcnn.build_cnn_train_step(cj))(
        pj, {"x": jnp.asarray(d["x"]), "y": jnp.asarray(d["y"])}, None)
    lt, gt = tcnn.build_cnn_train_step(ct)(
        pt, {"x": torch.from_numpy(d["x"]), "y": torch.from_numpy(d["y"])})
    assert abs(float(lt) - float(lj)) < 1e-5
    _check_grads(gt, gj, pt)


def test_sampled_gradients_match_reference_with_shared_masks():
    """CNN-S with feedback and column sampling: the reference draws each
    layer's masks from ``fold_in(key, i)``; the same masks go to the port."""
    cj, ct, pj, pt, d = _setup("cnn-s", batch=4)
    scj = JSparsityConfig(alpha_w=0.6, alpha_c=0.6)
    key = jax.random.PRNGKey(5)
    lj, gj = jax.jit(jcnn.build_cnn_train_step(cj, scj))(
        pj, {"x": jnp.asarray(d["x"]), "y": jnp.asarray(d["y"])}, key)
    n_cols = {"l0": 4 * 14 * 14, "l1": 4 * 7 * 7, "l2": 4}
    masks = {name: convert.subspace_masks(jcnn._layer_masks(
        pj[name], jax.random.fold_in(key, i), scj, n_cols[name]))
        for i, name in enumerate(n_cols)}
    assert all(m.feedback is not None and m.column is not None
               for m in masks.values())
    step = tcnn.build_cnn_train_step(ct, SparsityConfig(alpha_w=0.6,
                                                        alpha_c=0.6))
    lt, gt = step(pt, {"x": torch.from_numpy(d["x"]),
                       "y": torch.from_numpy(d["y"])}, masks=masks)
    assert abs(float(lt) - float(lj)) < 1e-5
    _check_grads(gt, gj, pt)
    drawn = tcnn.cnn_masks(pt, ct, 4, torch.Generator().manual_seed(0),
                           SparsityConfig(alpha_w=0.6, alpha_c=0.6))
    for name, m in masks.items():
        assert drawn[name].feedback.shape == m.feedback.shape
        assert drawn[name].column.shape == m.column.shape


def test_sampled_training_step_runs_and_learns():
    cfg = tcnn.MLP_VOWEL
    params = tcnn.init_cnn(torch.Generator().manual_seed(0), cfg)
    step = tcnn.build_cnn_train_step(cfg, SparsityConfig(alpha_w=0.6,
                                                         alpha_c=0.6))
    d = synthetic_vision(0, 0, 128, (8,), 4, noise=0.5)
    batch = {"x": torch.from_numpy(d["x"]), "y": torch.from_numpy(d["y"])}
    tr = trainable_mask(params)
    keys = [(n, l) for n in params for l in params[n] if tr[n][l]]
    opt, ocfg = init_opt_state([params[n][l] for n, l in keys]), \
        AdamWConfig(lr=5e-3)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(40):
        loss, grads = step(params, batch, gen)
        new, opt, _ = apply_updates([params[n][l] for n, l in keys],
                                    [grads[n][l] for n, l in keys], opt, ocfg)
        for (n, l), val in zip(keys, new):
            params[n][l] = val
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
