"""Port parity: the paper's tables (``repro_torch.benchmarks``) against
the reference's ``benchmarks/`` on the CPU.

The profiler tables come from the same code on both sides, so Tables 1
and 2 and Fig. 10 emit equal rows.  The other tables draw their random
inputs, which torch cannot replay from ``jax.random``; each test makes
the draws once (numpy, or ``jax.random`` exactly as the reference's jobs
make them) and hands them to the port's table function and to a replica
of the reference benchmark's ``main`` loop on the reference's functions,
at a tiny budget:

* Fig. 8 (n_mc 4): angular similarities and normalized distances to
  1e-5 (the feedback masks come from one shared uniform draw through each
  package's own sampler);
* Table 3 (k 8 and 12, a 24 × 24 weight): rel_err to 1e-4;
* Figs. 4 and 5 and Table 4: by their result metrics, as
  ``tests/test_torch_flow.py`` compares IC and PM (1e-3 relative; the
  reference's search runs in float64 under the suite's x64 setting and
  the port's in fp32).  Figs. 4 and 5 run 12 and 10 steps: ZGD's moves
  are continuous, so once an fp32 rounding difference carries a phase
  across an 8-bit quantization step the two searches part (Fig. 5's ZGD
  agrees to 1.3e-7 after 10 steps, 3.5e-4 after 20 and 5.5e-3 after 40,
  while its ZTP stays within 6e-7 over 40);
* Fig. 5's reference runs with x64 off (its ZGD and ZTP scans fail under
  x64 on a float32 weight), restored afterwards;
* Table 5: the loss of a few AdamW steps to 1e-4 from the reference's
  factorization carried across, and the accuracy after them.

A last check runs the port's profiler tables through its runner and finds
that only ``bench_artifacts/torch/`` was written.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:            # the reference's benchmarks/
    sys.path.insert(0, str(REPO))

from benchmarks import grad_fidelity as jgf                      # noqa: E402
from benchmarks import sampling_table2 as jt2                    # noqa: E402
from benchmarks import scalability as jscal                      # noqa: E402
from repro.core import sparsity as jsp                           # noqa: E402
from repro.core.calibration import calibrate_identity as j_ic    # noqa: E402
from repro.core.mapping import parallel_map as j_pm              # noqa: E402
from repro.core.noise import NoiseModel as JNoiseModel           # noqa: E402
from repro.core.ptc import PTCParams as JPTCParams               # noqa: E402
from repro.core.subspace import SubspaceMasks as JMasks          # noqa: E402
from repro.core.subspace import ptc_linear as j_ptc_linear       # noqa: E402
from repro.hw.device import sample_device as j_sample_device     # noqa: E402
from repro.optim import optimizers as jopt                       # noqa: E402
from repro.optim.zo import ZOConfig                               # noqa: E402
from repro_torch import convert                                   # noqa: E402
from repro_torch.benchmarks import (blocksize_tables, common,     # noqa: E402
                                    grad_fidelity, ic_convergence,
                                    mapping_osp, run, sampling_table2,
                                    scalability)
from repro_torch.core.ptc import PTCParams                        # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-3


@pytest.fixture
def no_x64():
    """The reference with x64 off for the test, restored in ``finally``."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _collect(monkeypatch, module):
    """The reference module's emitted tables, {name: rows}, written
    nowhere."""
    out = {}
    monkeypatch.setattr(module, "emit",
                        lambda name, header, rows: out.setdefault(name, rows))
    return out


# -- Tables 1 and 2, Fig. 10: equal rows --------------------------------------


@pytest.mark.parametrize("mine,ref", [(sampling_table2, jt2),
                                      (scalability, jscal)],
                         ids=["table2", "fig10_table1"])
def test_profiler_tables_equal_reference(mine, ref, monkeypatch, tmp_path):
    want = _collect(monkeypatch, ref)
    ref.main("quick")
    monkeypatch.setattr(common, "ART", tmp_path)
    got = mine.main("quick")
    assert set(got) == set(want) and want
    for name in want:
        assert got[name] == want[name], name
        assert (tmp_path / f"{name}.csv").is_file()


# -- Fig. 8 ---------------------------------------------------------------------


def _fig8_draws(mc: int = 4):
    """Fig. 8's draws in numpy: Haar factors, skew, x, δy, the feedback
    samplers' uniform draw, kept columns and spatial keep vectors."""
    rng = np.random.default_rng(11)
    p = q = grad_fidelity.M // grad_fidelity.K
    k = grad_fidelity.K

    def haar():
        g = rng.standard_normal((p, q, k, k))
        qm, rm = np.linalg.qr(g)
        return qm * np.sign(np.diagonal(rm, axis1=-2, axis2=-1))[..., None, :]

    u, v = haar(), haar()
    s = rng.standard_normal((p, q, k)) * np.exp(
        1.5 * rng.standard_normal((p, q, 1)))
    t = grad_fidelity.T
    f32 = np.float32
    return dict(
        u=u.astype(f32), s=s.astype(f32), v=v.astype(f32),
        x=rng.standard_normal((t, grad_fidelity.N)).astype(f32),
        dy=rng.standard_normal((t, grad_fidelity.M)).astype(f32),
        noise=np.maximum(rng.random((mc, q, p)), 1e-20).astype(f32),
        col_idx={a: np.stack([rng.permutation(t)[:round(a * t)]
                              for _ in range(mc)])
                 for a in grad_fidelity.ALPHAS},
        spatial={a: rng.random((mc, grad_fidelity.N)) < a
                 for a in grad_fidelity.ALPHAS})


def _j_feedback_mask(noise, be, cfg):
    """The reference sampler's formula (``repro/core/sparsity.py``) on a
    given uniform draw; topk draws nothing."""
    p = be.shape[0]
    keep = max(1, int(round(cfg.alpha_w * p)))
    if cfg.feedback_mode == "topk":
        return jsp.feedback_mask(jax.random.PRNGKey(0), be, cfg)
    noise = jnp.asarray(noise, jnp.float32)
    if cfg.feedback_mode == "uniform":
        mask = jsp._row_balanced_topk(noise, keep)
    else:
        guided = jnp.log(be.T.astype(jnp.float32) + 1e-12) \
            - jnp.log(-jnp.log(noise))
        mask = jsp._row_balanced_topk(guided, keep)
    return mask.astype(jnp.float32) * cfg.normalizer(keep / p,
                                                     cfg.feedback_norm)


def _j_fig8(d):
    """``benchmarks/grad_fidelity.py``'s main loop on the given draws;
    rows unrounded."""
    params = JPTCParams(*(jnp.asarray(d[f]) for f in ("u", "s", "v")))
    x, dy = jnp.asarray(d["x"]), jnp.asarray(d["dy"])
    dx_true, ds_true = jgf._true_grads(params, x, dy)
    be = jnp.sum(params.s ** 2, axis=-1)
    mc = d["noise"].shape[0]
    ab = []
    for mode in grad_fidelity.STRATEGIES:
        for alpha in grad_fidelity.ALPHAS:
            for norm in grad_fidelity.NORMS:
                cfg = jsp.SparsityConfig(alpha_w=alpha, feedback_mode=mode,
                                         feedback_norm=norm)
                cs = nd = 0.0
                for noise in d["noise"]:
                    masks = JMasks(_j_feedback_mask(noise, be, cfg), None)
                    _, vjp = jax.vjp(lambda xx: j_ptc_linear(
                        xx, params, masks, mode="blocked"), x)
                    g = vjp(dy)[0]
                    cs += jgf._angular(g, dx_true)
                    nd += jgf._ndist(g, dx_true)
                ab.append([mode, alpha, norm, cs / mc, nd / mc])
    cd = []
    t = x.shape[0]
    for alpha in grad_fidelity.ALPHAS:
        for kind in ("column", "spatial"):
            cfg = jsp.SparsityConfig(alpha_c=alpha, column_norm="exp")
            cs = nd = 0.0
            for i in range(mc):
                if kind == "column":
                    col = jnp.zeros((t,), jnp.float32).at[
                        d["col_idx"][alpha][i]].set(1.0) * cfg.normalizer(
                            d["col_idx"][alpha].shape[1] / t, "exp")
                    xs, masks = x, JMasks(None, col)
                else:
                    keep = jnp.asarray(d["spatial"][alpha][i])
                    xs, masks = x * keep[None, :] / alpha, None
                _, vjp = jax.vjp(lambda ss: j_ptc_linear(
                    xs, JPTCParams(params.u, ss, params.v), masks,
                    mode="blocked"), params.s)
                gs = vjp(dy)[0]
                cs += jgf._angular(gs, ds_true)
                nd += jgf._ndist(gs, ds_true)
            cd.append([kind, alpha, cs / mc, nd / mc])
    return ab, cd


def test_fig8_matches_reference():
    d = _fig8_draws()
    draws = grad_fidelity.Draws(
        PTCParams(*(torch.from_numpy(d[f]) for f in ("u", "s", "v"))),
        torch.from_numpy(d["x"]), torch.from_numpy(d["dy"]),
        torch.from_numpy(d["noise"]),
        {a: torch.from_numpy(i) for a, i in d["col_idx"].items()},
        {a: torch.from_numpy(m) for a, m in d["spatial"].items()})
    want_ab, want_cd = _j_fig8(d)
    got_ab, got_cd = grad_fidelity.fig8ab(draws), grad_fidelity.fig8cd(draws)
    assert len(got_ab) == 18 and len(got_cd) == 4
    for got, want in zip(got_ab + got_cd, want_ab + want_cd):
        n = len(got) - 2
        assert got[:n] == want[:n]
        for a, b in zip(got[n:], want[n:]):
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (got, want)
    # the sampled estimators are not the true gradient; topk at keep 0.6
    # is nearly exact, as the reference's table shows
    assert all(0.0 < r[3] < 1.0 + 1e-6 for r in got_ab)
    assert got_ab[9][3] > 0.99


# -- Table 3 --------------------------------------------------------------------


def test_table3_matches_reference():
    size, ks = 24, (8, 12)
    w = blocksize_tables.t3_weight(size)
    post = JNoiseModel().post_ic()
    devs, want = {}, []
    for k in ks:
        key = jax.random.PRNGKey(k)
        dev = j_sample_device(key, ((-(-size // k)) ** 2,), k, post)
        devs[k] = convert.device_realization(dev)
        pm = j_pm(key, jnp.asarray(w.numpy()), k, post, run_zo=False,
                  dev=dev)
        want.append(float(np.sqrt(np.asarray(pm.err_osp).mean())))
    got = blocksize_tables.table3(w, devs, "cpu")
    assert [r[0] for r in got] == list(ks)
    for (k, rel, paper), ref in zip(got, want):
        assert abs(rel - ref) <= 1e-4 * ref, (k, rel, ref)
        assert paper == blocksize_tables.PAPER_T3[k]


# -- Figs. 4 and 5, Table 4: result metrics under shared ZO draws ---------------


def _jax_draws(key, n_blocks, steps, method, n, hi):
    """Per-block, per-step draws as ``optim/zo.py`` makes them from the
    keys ``hw/jobs.py`` splits for each block: ``randint`` in [0, hi) for
    zcd, else normal (n,) vectors."""
    def block(kb):
        ks = jax.random.split(kb, steps)
        if method == "zcd":
            return jax.vmap(lambda kt: jax.random.randint(kt, (), 0, hi))(ks)
        return jax.vmap(lambda kt: jax.random.normal(kt, (n,)))(ks)
    return torch.as_tensor(np.array(jax.vmap(block)(
        jax.random.split(key, n_blocks))))


def _ic_pair(key, n_blocks, k, model, method, cfg, restarts):
    """(reference ICResult, port device realization, port draws) of one
    IC search keyed like ``calibrate_identity(key, ...)``."""
    kd, ko = jax.random.split(key)
    dev = j_sample_device(kd, (n_blocks,), k, model)
    res = j_ic(key, n_blocks, k, model, method=method, cfg=cfg, dev=dev,
               restarts=restarts)
    n = k * (k - 1)
    draws = torch.stack([_jax_draws(jax.random.fold_in(ko, r), n_blocks,
                                    cfg.steps, method, n, n)
                         for r in range(restarts)])
    return res, convert.device_realization(dev), draws


def _ic_metrics(res):
    return (float(np.asarray(res.loss).mean()),
            (float(np.asarray(res.mse_u).mean())
             + float(np.asarray(res.mse_v).mean())) / 2)


def test_fig4_matches_reference():
    cfg = ZOConfig(steps=12, inner=72, delta0=0.5, decay=1.05, lr0=0.3,
                   record_every=4)
    model = JNoiseModel()
    key = jax.random.PRNGKey(0)
    draws, want = {}, {}
    for method in ic_convergence.METHODS:
        res, dev, draws[method] = _ic_pair(
            key, ic_convergence.N_BLOCKS, ic_convergence.K, model, method,
            cfg, ic_convergence.RESTARTS)
        draws["dev"] = dev                 # one key: one realization
        want[method] = res
    rows = ic_convergence.fig4(draws, convert.zo_config(cfg),
                               convert.noise_model(model), "cpu")
    assert [r[0] for r in rows] == list(ic_convergence.METHODS)
    for method, loss, mse, trace in rows:
        j_loss, j_mse = _ic_metrics(want[method])
        assert abs(loss - j_loss) <= REL * j_loss, (method, loss, j_loss)
        assert abs(mse - j_mse) <= REL * j_mse, (method, mse, j_mse)
        j_trace = np.asarray(want[method].history).mean(0)
        assert trace.shape == j_trace.shape == (2 * 12 // 4,)
        assert np.allclose(trace, j_trace, rtol=REL)


def test_fig5_matches_reference(no_x64):
    cfg = ZOConfig(steps=10, inner=72, delta0=8 * 2 * np.pi / 255,
                   decay=1.05, lr0=0.1)
    model = JNoiseModel()
    model = dataclasses.replace(model.post_ic(), gamma_std=0.01,
                                crosstalk=0.01)
    assert convert.noise_model(model) == mapping_osp.harsh_model()
    w = mapping_osp.weight()
    key = jax.random.PRNGKey(1)
    kd, ko = jax.random.split(key)
    b, t = 9, 36
    dev = j_sample_device(kd, (b,), mapping_osp.K, model)
    draws, want = {"dev": convert.device_realization(dev)}, {}
    for method in mapping_osp.METHODS:
        pm = j_pm(key, jnp.asarray(w.numpy()), mapping_osp.K, model,
                  method=method, cfg=cfg, dev=dev)
        want[method] = [float(np.asarray(getattr(pm, e)).mean())
                        for e in ("err_init", "err_zo", "err_osp")]
        draws[method] = _jax_draws(ko, b, cfg.steps, method, 2 * t, 1 << 30)
    rows = mapping_osp.fig5(w, draws, convert.zo_config(cfg),
                            mapping_osp.harsh_model(), "cpu")
    for method, *errs in rows:
        for got, ref in zip(errs, want[method]):
            assert abs(got - ref) <= REL * ref, (method, errs, want[method])
        assert errs[2] <= errs[1] * (1 + 1e-4)       # OSP never worsens


def test_table4_matches_reference():
    model = JNoiseModel()
    cfgs, draws, want = {}, {}, {}
    for k in (8, 12):
        t = k * (k - 1) // 2
        cfgs[k] = ZOConfig(steps=t, inner=2 * t, delta0=0.5, decay=1.05)
        res, dev, zo = _ic_pair(jax.random.PRNGKey(k), 4, k, model, "zcd",
                                cfgs[k], 2)
        draws[k], want[k] = (dev, zo), _ic_metrics(res)[1]
    rows = blocksize_tables.table4(
        draws, {k: convert.zo_config(c) for k, c in cfgs.items()}, "cpu")
    for k, mse, paper in rows:
        assert abs(mse - want[k]) <= REL * want[k], (k, mse, want[k])
        assert paper == blocksize_tables.PAPER_T4[k]


# -- Table 5 --------------------------------------------------------------------


def test_table5_training_matches_reference():
    """A few Σ-only AdamW steps of Table 5's fused two-layer net from the
    reference's factorization: the losses to 1e-4, then the accuracy."""
    from repro.core.ptc import random_factorize as j_random_factorize
    d, n_cls, k, steps = 96, 8, 12, 4
    x, y, xt, yt = blocksize_tables.t5_data()
    key = jax.random.PRNGKey(100 + k)
    p1 = j_random_factorize(jax.random.fold_in(key, 0), d, d, k)
    p2 = j_random_factorize(jax.random.fold_in(key, 1), max(n_cls, k), d, k)

    def pad_to(xb, params):
        return jnp.pad(xb, ((0, 0), (0, params.grid[1] * k - xb.shape[1])))

    def logits_fn(sv, xb):
        a = JPTCParams(p1.u, sv["s1"], p1.v)
        b = JPTCParams(p2.u, sv["s2"], p2.v)
        h = jax.nn.relu(j_ptc_linear(pad_to(xb, a), a, mode="fused"))
        return j_ptc_linear(pad_to(h, b), b, mode="fused")[:, :n_cls]

    def loss(sv, xb, yb):
        lg = logits_fn(sv, xb)
        gold = jnp.take_along_axis(lg, yb[:, None], -1)[:, 0]
        return jnp.mean(jax.nn.logsumexp(lg, -1) - gold)

    sv = {"s1": p1.s, "s2": p2.s}
    opt, ocfg = jopt.init_opt_state(sv), jopt.AdamWConfig(lr=5e-3)
    want = []
    value_and_grad = jax.jit(jax.value_and_grad(loss))
    for _ in range(steps):
        val, g = value_and_grad(sv, jnp.asarray(x), jnp.asarray(y))
        want.append(float(val))
        sv, opt, _ = jopt.apply_updates(sv, g, opt, ocfg)
    j_acc = float((jnp.argmax(logits_fn(sv, jnp.asarray(xt)), -1)
                   == jnp.asarray(yt)).mean())

    t1, t2 = convert.ptc_params(p1), convert.ptc_params(p2)
    s, losses = blocksize_tables.train_sigma(
        t1, t2, torch.from_numpy(x), torch.from_numpy(y), steps)
    assert losses.shape == (steps,)
    for got, ref in zip(losses.tolist(), want):
        assert abs(got - ref) <= 1e-4 * abs(ref), (losses, want)
    acc = blocksize_tables.t5_accuracy(t1, t2, s, torch.from_numpy(xt),
                                       torch.from_numpy(yt))
    assert abs(acc - j_acc) <= 1 / 512 + 1e-9, (acc, j_acc)


# -- outputs --------------------------------------------------------------------


def test_runner_writes_only_under_bench_artifacts_torch():
    art = REPO / "bench_artifacts"
    assert common.ART == art / "torch"

    def snapshot():
        return {p: p.stat().st_mtime_ns for p in art.rglob("*")
                if p.is_file()} if art.is_dir() else {}

    before = snapshot()
    recs = run.run("quick", only="table2", device="cpu") \
        + run.run("quick", only="fig10", device="cpu")
    assert [r["name"] for r in recs] == ["table2_sampling",
                                         "fig10_scalability"]
    assert all(r["launches"] == {} for r in recs)   # the cost model only
    changed = [p for p, m in snapshot().items() if before.get(p) != m]
    assert changed, "the runner wrote nothing"
    assert all(p.parent == art / "torch" for p in changed), changed
    assert {p.name for p in changed} == {
        "table2_vgg8.csv", "table2_resnet18.csv", "fig10_scalability.csv",
        "table1_protocols.csv"}
