"""Port parity for the quickstart flow as a whole: calibrate → map →
serve → subspace learning at the reference quickstart's geometry
(18 → 18 → 9 MLP, k = 9), on the CPU.

Both packages get the same data, the same pre-trained weights (trained by
the reference's AdamW and carried across), the same device realizations
(sampled by the reference) and the same per-step ZO draws (made with
``jax.random`` as the reference's jobs make them), with the ZO budgets cut
on both sides to keep the test short.  The reference's IC search runs in
float64 under the suite's x64 setting and the port in fp32; ZCD's
``f_plus < f`` branch can flip on such reordering, so the searches are
compared by their metrics, not step by step.  With these seeds no branch
flips and the metrics agree to about 1e-6; the tolerances leave room for
fp32 rounding and nothing more:

* IC identity MSE (mean over blocks and both meshes): 1e-3 relative;
* PM err_init / err_zo / err_osp (mean over blocks, per layer): 1e-3
  relative.  Both packages SVD the same fp32 blocks; were a
  singular-vector pair to come out with flipped signs, the commanded
  phases (not the composed weight) would differ, and so would the noise
  they meet;
* served accuracy through ``forward_layer``: within 1 of 1024 rows.

The optimizer is checked on its own: a few AdamW and SGD steps on the same
gradients agree to 1e-6.

Subspace learning is checked on one step of the reference quickstart's
stage 3 from the reference's mapped factors, with Σ, the sampled masks
(drawn by the reference) and the data shared: loss and Σ-gradients to
1e-5 relative, the AdamW update to 1e-6.  The port's SL stage then runs a
cut budget of 20 steps on its own mapped chips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.calibration import calibrate_identity as j_calibrate
from repro.core.mapping import parallel_map as j_parallel_map
from repro.core import ptc as jptc, subspace as jsub
from repro.core.noise import NoiseModel as JNoiseModel
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro.data import synthetic_vision as j_synthetic_vision
from repro.hw.device import sample_device as j_sample_device
from repro.optim import optimizers as jopt
from repro.optim.zo import ZOConfig
from repro_torch import convert
from repro_torch.core.calibration import calibrate_identity
from repro_torch.core.mapping import parallel_map
from repro_torch import quickstart
from repro_torch.data.synthetic import synthetic_vision
from repro_torch.kernels import build
from repro_torch.optim import optimizers as topt

D_IN, D_H, D_OUT, K = 18, 18, 9, 9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IC_CFG = ZOConfig(steps=100, inner=72, delta0=0.5, decay=1.05)
IC_RESTARTS = 1
PM_CFG = ZOConfig(steps=60, inner=72, delta0=2 * np.pi / 255.0 * 8,
                  decay=1.05)
REL = 1e-3


def _zcd_draws(key, n_blocks, steps, hi):
    """Per-block, per-step ``randint`` draws as ``optim/zo.py`` makes them
    from the keys ``hw/jobs.py`` splits for each block."""
    return np.array(jax.vmap(lambda kb: jax.vmap(
        lambda kt: jax.random.randint(kt, (), 0, hi))(
            jax.random.split(kb, steps)))(jax.random.split(key, n_blocks)))


@pytest.fixture(scope="module")
def pretrained():
    data = j_synthetic_vision(0, 0, 1024, (D_IN,), D_OUT, noise=0.8)
    mine = synthetic_vision(0, 0, 1024, (D_IN,), D_OUT, noise=0.8)
    assert all(np.array_equal(data[f], mine[f]) for f in ("x", "y"))
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    rng = np.random.default_rng(0)
    ws = [jnp.asarray(rng.standard_normal((D_H, D_IN)) * 0.4, jnp.float32),
          jnp.asarray(rng.standard_normal((D_OUT, D_H)) * 0.4, jnp.float32)]
    opt, ocfg = jopt.init_opt_state({"w": ws}), jopt.AdamWConfig(lr=5e-3)

    def loss(w):
        logits = jax.nn.relu(x @ w[0].T) @ w[1].T
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, y[:, None], -1)[:, 0])

    @jax.jit
    def step(ws, opt):
        g = jax.grad(lambda w: loss(w["w"]))({"w": ws})
        new, opt, _ = jopt.apply_updates({"w": ws}, g, opt, ocfg)
        return new["w"], opt

    for _ in range(200):
        ws, opt = step(ws, opt)
    return data, ws


@pytest.fixture(scope="module")
def flows(pretrained):
    data, ws = pretrained
    model = JNoiseModel()
    post = model.post_ic()
    out = {}

    # stage 1: IC on the first weight's 2 × 2 blocks
    n_ic = 4
    key = jax.random.PRNGKey(0)
    kd, ko = jax.random.split(key)
    dev = j_sample_device(kd, (n_ic,), K, model)
    ic_j = j_calibrate(key, n_ic, K, model, cfg=IC_CFG, dev=dev,
                       restarts=IC_RESTARTS)
    draws = np.stack([_zcd_draws(jax.random.fold_in(ko, r), n_ic,
                                 IC_CFG.steps, K * (K - 1))
                      for r in range(IC_RESTARTS)])
    ic_t = calibrate_identity(None, n_ic, K, convert.noise_model(model),
                              cfg=convert.zo_config(IC_CFG),
                              dev=convert.device_realization(dev),
                              restarts=IC_RESTARTS, device="cpu",
                              draws=torch.as_tensor(draws))
    out["ic"] = tuple((float(r.mse_u.mean()) + float(r.mse_v.mean())) / 2
                      for r in (ic_j, ic_t))

    # stage 2: PM of both weights, each on its own post-IC twin
    pms_j, pms_t = [], []
    for i, (w, w_t) in enumerate(zip(ws, convert.weights(ws))):
        key = jax.random.PRNGKey(1 + i)
        kd, ko = jax.random.split(key)
        b = (-(-w.shape[0] // K)) * (-(-w.shape[1] // K))
        dev = j_sample_device(kd, (b,), K, post)
        pms_j.append(j_parallel_map(key, w, K, post, cfg=PM_CFG, dev=dev))
        pms_t.append(parallel_map(
            None, w_t, K, convert.noise_model(post),
            cfg=convert.zo_config(PM_CFG),
            dev=convert.device_realization(dev), device="cpu",
            draws=torch.as_tensor(_zcd_draws(ko, b, PM_CFG.steps, 1 << 30))))
    for name in ("err_init", "err_zo", "err_osp"):
        out[name] = [(float(getattr(pj, name).mean()),
                      float(getattr(pt, name).mean()))
                     for pj, pt in zip(pms_j, pms_t)]

    # serving through each package's chip serve forward
    xj = jnp.asarray(data["x"])
    hj = jax.nn.relu(pms_j[0].driver.forward_layer(xj))
    logits_j = np.asarray(pms_j[1].driver.forward_layer(hj))
    xt = torch.from_numpy(data["x"])
    logits_t = pms_t[1].driver.forward_layer(
        torch.relu(pms_t[0].driver.forward_layer(xt)))
    out["acc"] = tuple(float(np.mean(np.argmax(lg, -1) == data["y"]))
                       for lg in (logits_j, logits_t.numpy()))
    out["logits_t"] = logits_t
    out["params_j"] = [pj.params for pj in pms_j]
    out["params_t"] = [pt.params for pt in pms_t]
    return out


def test_identity_calibration_matches(flows):
    mse_j, mse_t = flows["ic"]
    assert abs(mse_t - mse_j) <= REL * mse_j, (mse_j, mse_t)


@pytest.mark.parametrize("name", ["err_init", "err_zo", "err_osp"])
def test_parallel_mapping_errors_match(flows, name):
    for err_j, err_t in flows[name]:
        assert abs(err_t - err_j) <= REL * err_j, (name, err_j, err_t)
    # OSP never makes a block worse than the search left it
    for (zo_j, zo_t), (osp_j, osp_t) in zip(flows["err_zo"], flows["err_osp"]):
        assert osp_t <= zo_t * (1 + 1e-4)


def test_served_accuracy_matches(flows):
    acc_j, acc_t = flows["acc"]
    assert abs(acc_t - acc_j) <= 1 / 1024 + 1e-9, (acc_j, acc_t)
    assert acc_t > 0.9
    assert flows["logits_t"].shape == (1024, D_OUT)
    assert bool(torch.isfinite(flows["logits_t"]).all())


@pytest.mark.parametrize("cfg_name", ["adamw", "sgd"])
def test_optimizer_steps_match(cfg_name):
    rng = np.random.default_rng(1)
    params = [rng.standard_normal((5, 3)).astype(np.float32),
              rng.standard_normal((4,)).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 3
              for p in params] for _ in range(4)]
    if cfg_name == "adamw":
        cj, ct = jopt.AdamWConfig(lr=1e-2), topt.AdamWConfig(lr=1e-2)
    else:
        cj = jopt.SGDConfig(lr=0.05, weight_decay=0.01, grad_clip=2.0)
        ct = topt.SGDConfig(lr=0.05, weight_decay=0.01, grad_clip=2.0)
    pj = {"w": [jnp.asarray(p) for p in params]}
    sj = jopt.init_opt_state(pj)
    pt = [torch.from_numpy(p.copy()) for p in params]
    st = topt.init_opt_state(pt)
    for g in grads:
        pj, sj, nj = jopt.apply_updates(pj, {"w": [jnp.asarray(a) for a in g]},
                                        sj, cj)
        pt, st, nt = topt.apply_updates(pt, [torch.from_numpy(a) for a in g],
                                        st, ct)
        assert abs(float(nt) - float(nj)) <= 1e-5 * float(nj)
    for a, b in zip(pt, pj["w"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_sl_step_matches_reference(pretrained, flows):
    data, _ = pretrained
    xj, yj = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    pj = [jptc.PTCParams(*(jnp.asarray(a, jnp.float32) for a in p))
          for p in flows["params_j"]]
    scfg = JSparsityConfig(alpha_w=0.6, alpha_c=0.6, alpha_d=0.2)
    key = jax.random.PRNGKey(3)
    masks = [jsub.sample_masks(jax.random.fold_in(key, i), pj[i],
                               xj.shape[0], scfg) for i in range(2)]

    def loss(sv):
        ps = [jptc.PTCParams(pj[i].u, sv["s"][i], pj[i].v) for i in range(2)]
        h = jax.nn.relu(jsub.ptc_linear(xj, ps[0], masks[0], mode="blocked"))
        logits = jsub.ptc_linear(h, ps[1], masks[1], mode="blocked")
        return jnp.mean(jax.nn.logsumexp(logits, -1)
                        - jnp.take_along_axis(logits, yj[:, None], -1)[:, 0])

    sv = {"s": [p.s for p in pj]}
    lj, gj = jax.value_and_grad(loss)(sv)
    newj, _, _ = jopt.apply_updates(sv, gj, jopt.init_opt_state(sv),
                                    jopt.AdamWConfig(lr=2e-3))

    pt = [convert.ptc_params(p) for p in pj]
    lt, gt = quickstart.sl_grads(
        pt, torch.from_numpy(data["x"]),
        torch.from_numpy(data["y"]).long(), D_H, D_OUT,
        [convert.subspace_masks(m) for m in masks])
    assert abs(float(lt) - float(lj)) <= 1e-5 * float(lj)
    for a, b in zip(gt, gj["s"]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    st = [p.s for p in pt]
    newt, _, _ = topt.apply_updates(st, gt, topt.init_opt_state(st),
                                    quickstart.SL_OPT)
    assert quickstart.SL_OPT == topt.AdamWConfig(lr=2e-3)
    for a, b in zip(newt, newj["s"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_sl_stage_runs_on_cpu(pretrained, flows):
    """The quickstart's stage 3 at a cut budget on the port's own mapped
    factors: plain versions only, finite, no loss of accuracy."""
    data, _ = pretrained
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"]).long()
    params = flows["params_t"]
    before = dict(build.launch_counts)
    sv, steps, loss = quickstart.subspace_learning(
        params, x, y, D_H, D_OUT, torch.Generator().manual_seed(3), steps=20)
    assert build.launch_counts == before
    assert 10 <= steps <= 20 and np.isfinite(loss)
    trained = [p._replace(s=s) for p, s in zip(params, sv)]
    with torch.no_grad():
        accs = [float((quickstart._ptc_logits(ps, x, D_H, D_OUT).argmax(-1)
                       == y).float().mean()) for ps in (params, trained)]
    assert accs[1] >= accs[0] - 0.01, accs
    assert not any(torch.equal(a, p.s) for a, p in zip(sv, params))
