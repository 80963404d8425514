"""Port parity: ``repro_torch.train_lm`` and ``repro_torch.onchip_transfer``
against the reference's ``examples/train_lm.py`` and
``examples/onchip_transfer.py`` on the CPU.

* ``train_lm`` at the ``tiny`` preset: the reference's chain built from its
  public functions (its example has only a ``main``), from the reference's
  seeded parameters carried over with ``convert.lm_params``; 10 update
  steps on ``lm_batch``, each loss and gradient norm within 1e-4
  (relative).
* ``onchip_transfer`` at the example's sizes (D = H = 36, C = 9, k = 9):
  the reference's task-A weights, its PM realizations (the port maps
  the weights onto them with its own ``parallel_map``) and its Σ and
  scratch draws handed to the port through ``draws=``; the reference
  side calls the example's own
  ``sigma_loss`` and ``accuracy`` (imported by path).  The mapped
  accuracies agree within one row in 1,024, the port's own pre-trained
  weights within 1e-3 of the reference's, and over 40 Σ steps of each of
  the three runs every step's loss within 1e-4 (relative) and the
  held-out accuracies within 2 rows in 768.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mapping import parallel_map as j_parallel_map
from repro.core.noise import NoiseModel as JNoiseModel
from repro.core.ptc import PTCParams as JPTCParams
from repro.core.ptc import random_factorize as j_random_factorize
from repro.data import lm_batch as j_lm_batch
from repro.data import synthetic_vision as j_synthetic_vision
from repro.data import transfer_vision as j_transfer_vision
from repro.hw.device import sample_device as j_sample_device
from repro.launch import steps as jsteps
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.optim.schedules import linear_warmup_cosine as j_warmup_cosine
from repro_torch import convert, onchip_transfer, train_lm

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-4
STEPS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- train_lm ----------------------------------------------------------------


def test_train_lm_tiny_matches_reference():
    p = train_lm.PRESETS["tiny"]
    tc = train_lm.arch("tiny")
    jc = jlm.ArchConfig(
        name=tc.name, family="dense", n_layers=p["n_layers"],
        d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab=p["vocab"], remat=False,
        ptc=jlayers.PTCLinearCfg(k=p["k"], mode="fused",
                                 base_dtype=jnp.float32))
    steps = 10
    params, opt = jsteps.init_train_state(jax.random.PRNGKey(0), jc)
    got = train_lm.run("tiny", steps=steps, device="cpu",
                       params=convert.lm_params(params))
    update = jax.jit(jsteps.build_update_step(
        jc, jopt.AdamWConfig(lr=3e-3), None,
        lambda s: j_warmup_cosine(s, 20, steps)))
    key = jax.random.PRNGKey(1)
    for step in range(steps):
        b = j_lm_batch(0, step, p["batch"], p["seq"], jc.vocab)
        params, opt, loss, gnorm = update(
            params, opt, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.fold_in(key, step))
        assert abs(got["losses"][step] - float(loss)) \
            <= LOSS_TOL * abs(float(loss)), step
        assert abs(got["gnorms"][step] - float(gnorm)) \
            <= LOSS_TOL * abs(float(gnorm)), step
    assert got["losses"][-1] < got["losses"][0]
    assert got["n_params"] == sum(x.size for x in jax.tree.leaves(params))


def test_train_lm_presets_are_the_references():
    ex = _example("train_lm")
    assert train_lm.PRESETS == ex.PRESETS
    cfg = train_lm.arch("100m")
    assert (cfg.remat, cfg.ptc.mode, cfg.ptc.base_dtype, cfg.ptc.k) == \
        (False, "fused", torch.float32, 64)


# -- onchip_transfer ---------------------------------------------------------

D, H, C, K = (onchip_transfer.D, onchip_transfer.H, onchip_transfer.C,
              onchip_transfer.K)


@pytest.fixture(scope="module")
def transfer():
    """The reference's run (its pre-training, PM and 40 Σ steps of each
    curve, every step's loss) and the port's run on its draws."""
    ex = _example("onchip_transfer")
    assert (ex.D, ex.H, ex.C, ex.K, ex.NOISE) == \
        (D, H, C, K, onchip_transfer.NOISE)
    noise = ex.NOISE
    a = j_synthetic_vision(1, 0, 1024, (D,), C, noise=noise)
    xa, ya = jnp.asarray(a["x"]), jnp.asarray(a["y"])
    rng = np.random.default_rng(0)
    ws = [jnp.asarray(rng.standard_normal((H, D)) * 0.4, jnp.float32),
          jnp.asarray(rng.standard_normal((C, H)) * 0.4, jnp.float32)]
    opt = jopt.init_opt_state({"w": ws})
    ocfg = jopt.AdamWConfig(lr=5e-3)

    def dloss(w):
        logits = jax.nn.relu(xa @ w[0].T) @ w[1].T
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, ya[:, None], -1)[:, 0])

    @jax.jit
    def dstep(ws, opt):
        g = jax.grad(lambda w: dloss(w["w"]))({"w": ws})
        new, opt, _ = jopt.apply_updates({"w": ws}, g, opt, ocfg)
        return new["w"], opt

    for _ in range(250):
        ws, opt = dstep(ws, opt)

    post = JNoiseModel().post_ic()
    devs, pm_a = [], []
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        kd, _ = jax.random.split(key)
        b = (-(-ws[i].shape[0] // K)) * (-(-ws[i].shape[1] // K))
        devs.append(j_sample_device(kd, (b,), K, post))
        pm_a.append(j_parallel_map(key, ws[i], K, post, run_zo=False,
                                   dev=devs[-1]).params)
    mapped = ex.accuracy({"s": [p.s for p in pm_a]}, pm_a, xa, ya)

    b = j_transfer_vision(1, 0, 1024, (D,), C, noise=noise)
    xb, yb = jnp.asarray(b["x"]), jnp.asarray(b["y"])
    bt = j_transfer_vision(1, 7, 768, (D,), C, noise=noise)
    xbe, ybe = jnp.asarray(bt["x"]), jnp.asarray(bt["y"])
    rnd = [j_random_factorize(jax.random.PRNGKey(33), H, D, K),
           j_random_factorize(jax.random.PRNGKey(34), C, H, K)]
    scratch = [j_random_factorize(jax.random.PRNGKey(70), H, D, K),
               j_random_factorize(jax.random.PRNGKey(71), C, H, K)]
    runs = {"transfer": (pm_a, [p.s for p in pm_a]),
            "transfer_bases": (pm_a, [r.s for r in rnd]),
            "scratch": (scratch, [p.s for p in scratch])}
    want = {}
    for name, (layers, s0) in runs.items():
        layers = [JPTCParams(p.u, p.s, p.v) for p in layers]
        sv = {"s": list(s0)}
        sopt = jopt.init_opt_state(sv)
        scfg = jopt.AdamWConfig(lr=4e-3)

        @jax.jit
        def step(sv, sopt, layers=layers):
            loss, g = jax.value_and_grad(
                lambda s: ex.sigma_loss(s, layers, xb, yb))(sv)
            sv, sopt, _ = jopt.apply_updates(sv, g, sopt, scfg)
            return sv, sopt, loss

        curve, losses = [], []
        for i in range(STEPS):
            if i % 20 == 0:
                curve.append((i, ex.accuracy(sv, layers, xbe, ybe)))
            sv, sopt, loss = step(sv, sopt)
            losses.append(float(loss))
        curve.append((STEPS, ex.accuracy(sv, layers, xbe, ybe)))
        want[name] = (curve, losses)

    def tensors(ts):
        return [torch.tensor(np.asarray(t, np.float32)) for t in ts]

    got = onchip_transfer.run(
        "cpu", steps=STEPS, draws=dict(
            dense=tensors(ws),
            dev=[convert.device_realization(d) for d in devs],
            sigma=tensors(r.s for r in rnd),
            scratch=[convert.ptc_params(p) for p in scratch]),
        log=lambda m: None)
    return dict(want=want, mapped=mapped, dense=ws, got=got)


def test_transfer_mapped_accuracy_matches(transfer):
    got = transfer["got"]["mapped_acc"]
    assert abs(got - transfer["mapped"]) <= 1 / 1024 + 1e-9, \
        (got, transfer["mapped"])
    assert got > 0.9


def test_transfer_pretraining_matches(transfer):
    """The port's own task-A pre-training from the same numpy weights:
    250 AdamW steps carry the two packages' fp32 summation orders (1.2e-4
    of the largest entry on this CPU), hence 1e-3."""
    for got, want in zip(transfer["got"]["dense"], transfer["dense"]):
        want = np.asarray(want, np.float64)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-3, err


@pytest.mark.parametrize("name", onchip_transfer.CURVES)
def test_transfer_curves_match(transfer, name):
    curve, losses = transfer["want"][name]
    got = transfer["got"]
    assert len(got["losses"][name]) == len(losses) == STEPS
    for i, (g, w) in enumerate(zip(got["losses"][name], losses)):
        assert abs(g - w) <= LOSS_TOL * abs(w), (name, i, g, w)
    assert [i for i, _ in got["curves"][name]] == [i for i, _ in curve]
    for (_, g), (_, w) in zip(got["curves"][name], curve):
        assert abs(g - w) <= 2 / 768 + 1e-9, (name, g, w)
    assert len(got["sigma10"][name]) == 2
    assert set(got["stages"]) == {"pretrain", "pm", "eval_a",
                                  *onchip_transfer.CURVES}
