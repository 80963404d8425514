"""Port parity: the LM training step — ``lm.build_train_step``,
``lm.inject_masks`` and ``launch.steps.build_update_step`` — against the
reference on the CPU.

Parameters come from the reference's ``init_model`` and are carried over
with ``convert.lm_params``; batches are made with numpy from a seed.
torch cannot replay ``jax.random``, so the sampled masks are drawn once by
the reference's ``inject_masks`` and handed to both train steps (each
package's ``inject_masks`` is swapped for one that attaches those ``fb`` /
``col`` leaves).
Errors are relative to the largest entry of the reference's.

* olmo-1b's loss and every trainable gradient leaf, with no sparsity
  and with α_W = α_C = 0.6, in fused and in blocked mode: 1e-5 in fp32;
  the returned tree has the reference's structure, scalar zeros at the
  frozen bases (the other families: ``test_torch_train_families.py``);
* with bf16 bases (olmo-1b blocked, masks): the loss within 2e-2, the
  gradients within 6e-2 (``BF16_GRAD_TOL``);
* the tensor-core routes' roundings (``kernels/ref.py``'s emulations)
  through 16 olmo-1b-shaped layers, and three planted kernel faults,
  against the limits ``chip_smoke.py`` holds the card's kernels to;
* three ``build_update_step`` steps (AdamW, ``linear_warmup_cosine``) from
  one state on the same ``lm_batch`` batches: the loss and every
  parameter after each step within 1e-5 (fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_util import (B, S, at, lm_inputs, model, rel, split_batch)
from repro.core.sparsity import SparsityConfig as JSparsity
from repro.data import lm_batch as j_lm_batch
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim.optimizers import AdamWConfig as JAdamW
from repro.optim.optimizers import init_opt_state as j_init_opt_state
from repro.optim.schedules import linear_warmup_cosine as j_warmup_cosine
from repro_torch import convert
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import steps
from repro_torch.models import lm as tlm
from repro_torch.optim.optimizers import AdamWConfig, init_opt_state
from repro_torch.optim.schedules import linear_warmup_cosine

TOL = 1e-5
BF16_TOL = 2e-2
# bf16 gradients: each Σ-gradient leaves the step through a bf16 rounding
# (the cast of Σ to the bases' dtype) after a backward of bf16 δy that the
# two frameworks round at different places; seeds 1-3 of the olmo-1b case
# read 1.5e-2 to 3.2e-2, and a single bf16 ptc_linear's gradients are held
# at 6e-2 in tests/test_torch_wide_blocks.py
BF16_GRAD_TOL = 6e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the port's many small ops then wait at every parallel
    region on threads the other workers hold.  It also fixes the two
    places where the thread count enters the 16-layer rounding readings
    below: the seeded bases (LAPACK's QR blocks by it, so the model's U
    and V differ in their last bits) and oneDNN's bf16 products (K split
    across four or more threads, the partial sums added in another order
    before the bf16 rounding)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks_only(tree):
    """The ``fb`` / ``col`` leaves of an injected tree, nested as found."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _masks_only(v)
            if sub:
                out[k] = sub
        elif k in ("fb", "col"):
            out[k] = v
    return out


def _attach(params, masks):
    out = dict(params)
    for k, v in masks.items():
        out[k] = _attach(params[k], v) if isinstance(v, dict) else v
    return out


def _train_steps(monkeypatch, name, mode, alpha_w=1.0, alpha_c=1.0,
                 bf16=False, seed=0):
    """Both packages' train steps on one state and batch, with the
    reference's masks handed to both: ((j_loss, j_grads), (t_loss,
    t_grads))."""
    jc, tc, jp, tp = model(name, mode, bf16)
    jb, tb = split_batch(lm_inputs(jc, seed=seed), bf16=bf16)
    jscfg = JSparsity(alpha_w=alpha_w, alpha_c=alpha_c)
    tscfg = SparsityConfig(alpha_w=alpha_w, alpha_c=alpha_c)
    if jscfg.enabled:
        jm = _masks_only(jlm.inject_masks(jp, jax.random.PRNGKey(5), jscfg,
                                          B * S))
        tm = convert.lm_params(jm)
        monkeypatch.setattr(jlm, "inject_masks",
                            lambda p, key, scfg, n: _attach(p, jm))
        monkeypatch.setattr(tlm, "inject_masks",
                            lambda p, gen, scfg, n: _attach(p, tm))
    want = jax.jit(jlm.build_train_step(jc, jscfg))(jp, jb,
                                                   jax.random.PRNGKey(0))
    got = tlm.build_train_step(tc, tscfg)(tp, tb, None)
    return want, got


def _check_grads(want, got, tol, loss_tol=None):
    (jloss, jg), (tloss, tg) = want, got
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss) - float(jloss)) <= \
        (loss_tol or tol) * abs(float(jloss))
    n = 0
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        t = at(tg, path)
        assert tuple(t.shape) == tuple(g.shape), path
        assert str(t.dtype).replace("torch.", "") == str(g.dtype), path
        if g.ndim == 0:                   # a frozen base's placeholder
            assert float(t) == 0.0
            continue
        assert rel(t, g) < tol, (path, rel(t, g))
        n += 1
    assert n > 0


@pytest.mark.parametrize("mode", ["fused", "blocked"])
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_train_step_matches_reference(monkeypatch, mode, alpha):
    """olmo-1b with no sparsity, and with α_W = α_C = 0.6."""
    _check_grads(*_train_steps(monkeypatch, "olmo-1b", mode, alpha, alpha),
                 TOL)


def test_train_step_with_bf16_bases_matches_reference(monkeypatch):
    want, got = _train_steps(monkeypatch, "olmo-1b", "blocked", 0.6, 0.6,
                             bf16=True, seed=1)
    _check_grads(want, got, BF16_GRAD_TOL, loss_tol=BF16_TOL)
    assert got[1]["pos0"]["attn"]["wq"]["s"].dtype == torch.float32


def test_update_steps_match_reference():
    """The slice as a whole: three AdamW steps with the warmup-cosine
    schedule from one converted state, each on its own ``lm_batch``
    batch; loss, gradient norm and every parameter after each step."""
    jc, tc, jp, tp = model("olmo-1b", "blocked")
    sched = (lambda st: j_warmup_cosine(st, 1, 3),
             lambda st: linear_warmup_cosine(st, 1, 3))
    jupd = jsteps.build_update_step(jc, JAdamW(lr=5e-3), None, sched[0])
    tupd = steps.build_update_step(tc, AdamWConfig(lr=5e-3), None,
                                   sched[1])
    jopt = j_init_opt_state(jp, jlm.model_trainable_mask(jp))
    topt = init_opt_state(steps.flatten(tp), steps.flatten(
        tlm.model_trainable_mask(tp)))
    for step in range(3):
        raw = j_lm_batch(0, step, B, S, jc.vocab)
        assert all(np.array_equal(raw[k], v)
                   for k, v in lm_batch(0, step, B, S, tc.vocab).items())
        jb = {k: jnp.asarray(v) for k, v in raw.items()}
        tb = {k: torch.from_numpy(v) for k, v in raw.items()}
        jp, jopt, jloss, jgn = jupd(jp, jopt, jb, jax.random.PRNGKey(step))
        tp, topt, tloss, tgn = tupd(tp, topt, tb, None)
        assert abs(float(tloss) - float(jloss)) <= TOL * float(jloss)
        assert abs(float(tgn) - float(jgn)) <= TOL * float(jgn)
        assert topt.step == int(jopt.step) == step + 1
        for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
            assert rel(at(tp, path), w) < TOL, (step, path)
    # Σ moved, the bases did not
    _, _, jp0, tp0 = model("olmo-1b", "blocked")
    up, up0 = tp["pos0"]["mlp"]["up"], tp0["pos0"]["mlp"]["up"]
    assert torch.equal(up["u"], up0["u"]) and torch.equal(up["v"], up0["v"])
    assert not torch.equal(up["s"], up0["s"])


def test_flatten_order_is_the_reference_leaf_order():
    jc, tc, jp, tp = model("whisper-base")
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(jp)]
    got = [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for a in steps.flatten(tp)]
    assert got == want
    back = steps.unflatten(tp, steps.flatten(tp))
    assert jax.tree.structure(back) == jax.tree.structure(tp)


def test_init_train_state_keeps_no_state_for_the_bases():
    cfg = dataclasses.replace(model("olmo-1b")[1], n_layers=1)
    params, opt = steps.init_train_state(torch.Generator().manual_seed(0),
                                         cfg)
    flat = steps.flatten(params)
    mask = steps.flatten(tlm.model_trainable_mask(params))
    assert len(opt.mu) == len(flat) and opt.step == 0
    for a, tr, m, master in zip(flat, mask, opt.mu, opt.master):
        assert m.shape == (a.shape if tr else ())
        if tr:
            assert torch.equal(master, a.float())


def _sigma_leaves(tree, path=()):
    """The Σ leaves of a gradient tree by their dotted paths (each stacked
    over its stack's layers)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_sigma_leaves(v, path + (k,)))
        elif k == "s":
            out[".".join(path + (k,))] = v
    return out


def sigma_deviation(got, want):
    """(the largest Σ-gradient difference over its leaf's largest entry,
    the largest over its own layer's largest entry) — the two measures
    ``chip_smoke.py``'s train phase holds, the second per stacked layer."""
    whole = max(float((got[n] - w).abs().max() / w.abs().max())
                for n, w in want.items())
    layer = max(float((got[n][i] - w[i]).abs().max() / w[i].abs().max())
                for n, w in want.items() for i in range(w.shape[0]))
    return whole, layer


def planted_faults():
    """Kernels with a planted fault, on top of the tensor-core routes'
    roundings: the Σ-gradient without its column mask; the feedback with
    its block mask ignored; the Σ-gradient without its column mask in the
    backward's first 7 calls only (the last layer's linears), a fault
    confined to one layer."""
    from repro_torch.kernels import ref
    calls = [0]

    def drop_col(dy, x, u, v, col=None):
        return ref.sigma_grad_tc_ref(dy, x, u, v, None)

    def ignore_mask(dy, u, s, v, mask):
        return ref.feedback_matmul_tc_ref(dy, u, s, v, torch.ones_like(mask))

    def drop_col_last_layer(dy, x, u, v, col=None):
        calls[0] += 1
        return ref.sigma_grad_tc_ref(dy, x, u, v,
                                     None if calls[0] <= 7 else col)
    return {"sigma_grad drops col": {"sigma_grad": drop_col},
            "feedback ignores its mask": {"feedback_matmul": ignore_mask},
            "sigma_grad drops col, last layer": {
                "sigma_grad": drop_col_last_layer}}


def tc_rounding_deviation(n_layers=16, d_model=512, tokens=512,
                          arch="olmo-1b", k=128, batch=1, faults=None):
    """One blocked training step of ``arch``'s structure at ``d_model``
    (PTC block ``k``, bf16 bases, α_W = α_C = 0.6; olmo-1b with vocab
    8192 and heads of 128, whisper-base with heads of 64) through the plain
    versions of the three PTC kernels, against the same step through
    ``kernels/ref.py``'s emulations of the tensor-core routes' roundings
    (U·diag(s) and W rounded to bf16): the loss's relative difference and
    :func:`sigma_deviation` — the differences ``chip_smoke.py``'s train
    phase holds the card's kernels to against the plain versions.  With
    ``faults`` (name → kernel swaps), the same for each fault planted on
    top of the roundings: {name or "tc": (loss, whole, per layer)}."""
    from repro_torch.configs import get_config
    from repro_torch.core import subspace
    from repro_torch.kernels import ref
    from repro_torch.models import layers as tlayers
    hd = 128 if arch == "olmo-1b" else 64
    cfg = dataclasses.replace(
        get_config(arch), n_layers=n_layers, d_model=d_model,
        d_ff=4 * d_model, n_heads=d_model // hd, n_kv_heads=d_model // hd,
        head_dim=hd, vocab=8192, ptc=tlayers.PTCLinearCfg(
            k=k, mode="blocked", base_dtype=torch.bfloat16))
    if cfg.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)
    params = tlm.init_model(torch.Generator().manual_seed(0), cfg)
    data = {k: torch.from_numpy(v).long()
            for k, v in lm_batch(0, 0, batch, tokens, cfg.vocab).items()}
    if cfg.family == "encdec":
        data["frames"] = (0.5 * torch.randn(
            (batch, tokens, d_model), generator=torch.Generator(
            ).manual_seed(1))).to(torch.bfloat16)
    step = tlm.build_train_step(cfg, SparsityConfig(alpha_w=0.6,
                                                    alpha_c=0.6))
    tc = {"ptc_block_matmul": ref.ptc_block_matmul_tc_ref,
          "sigma_grad": ref.sigma_grad_tc_ref,
          "feedback_matmul": ref.feedback_matmul_tc_ref}

    def run(swaps):
        saved = {k: getattr(subspace, k) for k in swaps}
        try:
            for k, fn in swaps.items():
                setattr(subspace, k, fn)
            loss, grads = step(params, data, torch.Generator().manual_seed(1))
        finally:
            for k, fn in saved.items():
                setattr(subspace, k, fn)
        return float(loss), _sigma_leaves(grads)

    loss0, plain = run({})
    out = {}
    for name, swaps in {"tc": {}, **(faults or {})}.items():
        loss, got = run({**tc, **swaps})
        out[name] = (abs(loss - loss0) / abs(loss0),
                     *sigma_deviation(got, plain))
    return out


# chip_smoke.py's limits for the kernels against their plain versions
CARD_LOSS_TOL, CARD_SIGMA_TOL, CARD_SIGMA_LAYER_TOL = 3e-4, 6e-2, 1.2e-1


@pytest.fixture(scope="module")
def rounding_16_layers():
    """The tensor-core roundings and the planted faults through 16 layers:
    the plain step once, then each swapped step once, for both tests."""
    return tc_rounding_deviation(faults=planted_faults())


def test_tensor_core_roundings_through_16_layers(rounding_16_layers):
    """The deviation the card's train phase allows (``TRAIN_SIGMA_TOL``
    6e-2 of a leaf's largest entry, ``TRAIN_SIGMA_LAYER_TOL`` 1.2e-1 of a
    layer's, ``TRAIN_LOSS_TOL`` 3e-4 in ``chip_smoke.py``) is 1.4 times or
    more what the tensor-core routes' roundings give through 16 layers
    here, and the per-layer limit twice or more."""
    loss, sigma, layer = rounding_16_layers["tc"]
    print(f"tensor-core roundings through 16 layers: loss {loss:.2e}, "
          f"Σ-gradients {sigma:.2e} of the leaf's largest entry, {layer:.2e}"
          f" of the layer's")
    assert 1e-3 < sigma < CARD_SIGMA_TOL / 1.4 and loss < 1.5e-4
    assert sigma <= layer < CARD_SIGMA_LAYER_TOL / 2


def test_planted_faults_exceed_the_card_limits(rounding_16_layers):
    """Each planted fault lifts the Σ-gradients' per-layer deviation past
    the card's limit; the fault confined to the last layer stays under
    the whole-leaf limit, which is why the card checks each layer."""
    out = rounding_16_layers
    for name, (loss, sigma, layer) in out.items():
        print(f"{name}: loss {loss:.2e}, Σ-gradients {sigma:.2e} of the "
              f"leaf's largest entry, {layer:.2e} of the layer's")
    for name in planted_faults():
        assert out[name][2] > 5 * CARD_SIGMA_LAYER_TOL
    assert out["sigma_grad drops col, last layer"][1] < CARD_SIGMA_TOL
