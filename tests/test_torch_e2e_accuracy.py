"""Port parity: the ``e2e_accuracy`` benchmark
(``repro_torch.benchmarks.e2e_accuracy``) on the CPU, at small sizes.

* Its constants and both budgets are the reference's
  (``benchmarks/e2e_accuracy.py:51-54``, the budget branches of its
  ``main``, read from its source); its fleet policy is the reference's
  carried across by ``convert.runtime_config``; ``_legality`` is the
  reference's, bit for bit.
* :func:`gates` gives the reference's gates on the committed reference
  artifact, and each planted curve flips exactly the gate it targets.
* Three update steps from the reference's ``init_train_state(PRNGKey(3))``,
  carried across, give its losses and Σ leaves within 1e-5.
* With the reference's parameters trained to legality accuracy 0.9 and
  carried across, both packages' σ = 0 routed runs score within 2 of the
  stream's positions.
* Within the port: route ≡ shadow predictions on the untrained model, and
  twin ≡ subprocess logits bit for bit on the trained one.
* Training repeats bit for bit on several CPU threads (the embedding's
  backward sums in one order), and two traces' first parting is found.
* Every metric and gate path of ``check_regression.SPECS`` for the
  benchmark's JSON resolves on the summary the port builds, and the runner
  registers the benchmark under the reference's name and order.
"""

import ast
import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import e2e_accuracy as jea
from repro.data import lm_batch as j_lm_batch
from repro.launch.steps import build_update_step as j_build_update_step
from repro.launch.steps import init_train_state as j_init_train_state
from repro.launch.train import parse_arch as j_parse_arch
from repro.optim.optimizers import AdamWConfig as JAdamW
from repro_torch import convert
from repro_torch.benchmarks import check_regression as tcr
from repro_torch.benchmarks import e2e_accuracy as tea
from repro_torch.benchmarks import run as bench_run
from repro_torch.configs import parse_arch
from repro_torch.data.synthetic import _markov_table, lm_batch
from repro_torch.launch.steps import flatten
from repro_torch.models.layers import embed

from _torch_lm_util import at, rel

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
# the fewest reference training steps whose σ = 0 routed run on the 2 × 17
# stream scores at least 0.9 (140 steps: 0.81; 160: 0.94)
TRAIN_STEPS = 160
# positions two packages' routed runs may disagree on (of 2 × 16 scored)
ACC_POSITIONS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the port's many small ops then wait at every parallel
    region on threads the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    return j_parse_arch(tea.ARCH), parse_arch(tea.ARCH)


@pytest.fixture(scope="module")
def jstate(cfgs):
    """The reference's initial state and its jitted update step."""
    params, opt = j_init_train_state(jax.random.PRNGKey(tea.SEED), cfgs[0])
    step = jax.jit(j_build_update_step(cfgs[0], JAdamW(lr=2e-3)))
    return params, opt, step


def _j_train(jstate, cfg, steps: int):
    """``steps`` reference update steps as its ``_train_model`` takes them;
    returns (params, each step's loss)."""
    params, opt, step = jstate
    key = jax.random.PRNGKey(tea.SEED)
    losses = []
    for i in range(steps):
        b = {k: jnp.asarray(v)
             for k, v in j_lm_batch(tea.SEED, i, 16, 32, cfg.vocab).items()}
        params, opt, loss, _ = step(params, opt, b, jax.random.fold_in(key, i))
        losses.append(float(loss))
    return params, losses


@pytest.fixture(scope="module")
def trained(jstate, cfgs):
    """The reference's parameters after ``TRAIN_STEPS`` steps, and the
    port's copy of them."""
    params, _ = _j_train(jstate, cfgs[0], TRAIN_STEPS)
    return params, convert.lm_params(params)


@pytest.fixture(scope="module")
def data(cfgs):
    table = _markov_table(cfgs[1].vocab, tea.SEED)
    stream = lm_batch(tea.SEED, 999, 6, 49, cfgs[1].vocab)["tokens"]
    return table, stream


def _reference_budgets() -> dict:
    """The reference ``main``'s two budget branches, read from its source
    (``train_steps, batch, stream_len, tail``, ``sigmas``, ``conf_len``)."""
    tree = ast.parse(Path(jea.__file__).read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    branch = next(n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and ast.unparse(n.test) == "budget == 'quick'")

    def values(body):
        out = {}
        for st in body:
            if not isinstance(st, ast.Assign):
                continue
            tgt, val = st.targets[0], ast.literal_eval(st.value)
            if isinstance(tgt, ast.Tuple):
                out.update(zip((e.id for e in tgt.elts), val))
            else:
                out[tgt.id] = tuple(val) if isinstance(val, list) else val
        return out

    return dict(quick=values(branch.body), normal=values(branch.orelse))


def test_constants_and_budgets_are_the_reference():
    for name in ("ARCH", "SEED", "FLEET", "FLEET_K"):
        assert getattr(tea, name) == getattr(jea, name), name
    assert tea.BUDGETS == _reference_budgets()


@pytest.mark.parametrize("driver", ["twin", "subprocess", "socket"])
@pytest.mark.parametrize("sigma", [0.0, 0.004, 0.014])
def test_runtime_cfg_is_the_reference(sigma, driver):
    assert tea._runtime_cfg(sigma, driver) == convert.runtime_config(
        jea._runtime_cfg(sigma, driver))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_legality_is_the_reference(seed):
    rng = np.random.default_rng(seed)
    vocab = 256
    table = _markov_table(vocab, tea.SEED)
    stream = rng.integers(0, vocab, (3, 12)).astype(np.int32)
    preds = rng.integers(0, vocab, (3, 11)).astype(np.int32)
    # about half the positions legal
    legal = table[stream[:, :11], rng.integers(0, 4, (3, 11))]
    preds = np.where(rng.random((3, 11)) < 0.5, legal, preds).astype(np.int32)
    got = tea._legality(preds, stream, table)
    want = jea._legality(preds, stream, table)
    assert got.dtype == want.dtype == bool
    assert np.array_equal(got, want) and 0 < got.sum() < got.size


@pytest.fixture(scope="module")
def artifact():
    return json.loads((REPO / "bench_artifacts"
                       / "BENCH_e2e_accuracy.json").read_text())


def _gates(base, sweep, g):
    return tea.gates(base, sweep, g["sigma0_token_identical"],
                     g["transport_bit_identical"])


def test_gates_on_the_reference_artifact(artifact):
    assert _gates(artifact["baseline"], artifact["sweep"],
                  artifact["gates"]) == artifact["gates"]


def _non_monotone(base, sweep):
    sweep[0]["open"]["accuracy"] = base["accuracy"] - 0.03
    sweep[1]["open"]["accuracy"] = base["accuracy"] - 0.015


def _no_fall(base, sweep):
    for s, drop in zip(sweep, (0.005, 0.01, 0.015)):
        s["open"]["accuracy"] = base["accuracy"] - drop


def _closed_tail_low(base, sweep):
    sweep[1]["closed"]["tail_accuracy"] = base["tail_accuracy"] - 0.011


def _closed_tail_at_limit(base, sweep):
    sweep[1]["closed"]["tail_accuracy"] = base["tail_accuracy"] - 0.01


@pytest.mark.parametrize("plant, flips", [
    (_non_monotone, "open_loop_monotone"),
    (_no_fall, "open_loop_monotone"),
    (_closed_tail_low, "closed_loop_recovers"),
    (_closed_tail_at_limit, None),
])
def test_planted_curves_flip_their_gate(artifact, plant, flips):
    base, sweep = artifact["baseline"], copy.deepcopy(artifact["sweep"])
    plant(base, sweep)
    want = dict(artifact["gates"])
    if flips is not None:
        want[flips] = False
    assert _gates(base, sweep, artifact["gates"]) == want


def test_update_steps_match_the_reference(jstate, cfgs):
    """Three update steps from the reference's initial state, carried
    across: each step's loss and the Σ leaves after the third."""
    jp0 = jstate[0]
    jp, jlosses = _j_train(jstate, cfgs[0], 3)
    for n in (1, 2, 3):
        tp, tloss = tea._train_model(cfgs[1], n, device="cpu",
                                     params=convert.lm_params(jp0))
        assert abs(tloss - jlosses[n - 1]) <= TOL * jlosses[n - 1], n
    n_sigma = 0
    for path, w in jax.tree_util.tree_flatten_with_path(jp)[0]:
        if path[-1].key == "s":
            assert rel(at(tp, path), w) < TOL, path
            n_sigma += 1
    assert n_sigma > 0


def test_trained_accuracy_matches_the_reference(trained, data):
    """σ = 0, the loop off, on a 2 × 17 stream: the two packages' routed
    legality accuracies within ``ACC_POSITIONS`` of its scored positions."""
    table, stream = data
    s = stream[:2, :17]
    want, _ = jea._run(trained[0], s, table, 0.0, 4, mode="route",
                       recal=False)
    got, out = tea._run(trained[1], s, table, 0.0, 4, mode="route",
                        recal=False, device="cpu")
    n = out["preds"].size
    assert n == 2 * 16
    assert want["accuracy"] >= 0.9
    assert abs(got["accuracy"] - want["accuracy"]) * n <= ACC_POSITIONS
    assert got["frames_per_step"] == want["frames_per_step"]
    assert len(out["report"]["hw"]["layers"]) == 14


def test_route_is_shadow_on_the_untrained_model(cfgs, data):
    table, stream = data
    params0 = tea._init_params(cfgs[1], "cpu")
    s = stream[:2, :9]
    (_, route), (_, shadow) = (
        tea._run(params0, s, table, 0.0, 4, mode=mode, recal=False,
                 device="cpu") for mode in ("route", "shadow"))
    assert route["preds"].shape == (2, 8)
    assert np.array_equal(route["preds"], shadow["preds"])
    assert tea._first_parting(route["preds"], shadow["preds"]) is None


def test_twin_is_subprocess_bit_for_bit(trained, data):
    table, stream = data
    s = stream[:2, :9]
    (_, twin), (_, sub) = (
        tea._run(trained[1], s, table, 0.0, 4, mode="route", driver=d,
                 recal=False, trace_logits=True, device="cpu")
        for d in ("twin", "subprocess"))
    assert twin["logits"].shape == (8, 2, 256)
    assert np.array_equal(twin["logits"], sub["logits"])


@pytest.mark.parametrize("got, want, where", [
    (np.zeros((2, 3)), np.zeros((2, 3)), None),
    (np.array([[1, 2, 3], [4, 5, 6]]), np.array([[1, 2, 3], [4, 0, 6]]),
     dict(request=1, position=1)),
    (np.ones((2, 3, 4)), np.pad(np.ones((2, 3, 3)), ((0, 0), (0, 0), (0, 1))),
     dict(request=0, position=0)),
])
def test_first_parting_names_the_request_and_position(got, want, where):
    assert tea._first_parting(got, want) == where


def test_summary_resolves_every_check_regression_path(artifact):
    a = artifact
    summary = tea.summarize(
        "quick", a["train_loss"], a["baseline"], a["n_ptc_layers"],
        a["transports"], a["sweep"], a["gates"], dict(train=1.0),
        dict(route_shadow=None), "cpu")
    assert set(summary) == set(a) | {"device", "leg_walls_s", "partings"}
    assert {k: summary[k] for k in a} == a
    spec = tcr.SPECS["BENCH_e2e_accuracy.json"]
    for name, fn in spec["metrics"].items():
        assert np.isfinite(float(fn(summary))), name
    for path in spec["gates"]:
        node = summary
        for key in path.split("."):
            node = node[key]
        assert isinstance(node, bool), path


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_embedding_gradient_repeats_bit_for_bit(four_threads):
    """The embedding's backward sums a repeated token's rows in one order
    on several threads (the index backward did not: two trainings from one
    seed parted in the last bit, and the trained task's near-tied logits
    then parted the served runs)."""
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 256, (16, 32), generator=g, dtype=torch.int32)
    dy = torch.randn((16, 32, 64), generator=g)
    grads = []
    for _ in range(20):
        e = torch.zeros((256, 64), requires_grad=True)
        embed({"e": e}, tokens).backward(dy)
        grads.append(e.grad)
    assert all(torch.equal(grads[0], x) for x in grads[1:])


def test_training_repeats_bit_for_bit(cfgs, four_threads):
    runs = [tea._train_model(cfgs[1], 3, device="cpu")[0] for _ in range(2)]
    assert all(torch.equal(a, b)
               for a, b in zip(flatten(runs[0]), flatten(runs[1])))


def test_runner_registers_the_benchmark():
    names = [name for name, _ in bench_run.RUNTIME]
    assert ("runtime_e2e_accuracy", tea.main) in bench_run.RUNTIME
    assert names.index("hw_driver_overhead") < names.index(
        "runtime_e2e_accuracy") < names.index("serving_gateway")
    assert ("runtime_e2e_accuracy", tea.main) in bench_run.BENCHES
