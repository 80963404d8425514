"""Port parity: the "dots" remat policy (``ArchConfig.remat_policy``).

The reference's "dots" checkpoints each period with
``dots_with_no_batch_dims_saveable``: the outputs of its products with no
batch dimension are kept, everything else is recomputed in the backward.
The port runs the period under ``torch.utils.checkpoint`` with a
selective-checkpoint policy that keeps the outputs of ``aten.mm`` /
``aten.addmm`` (the 2-D products: in fused mode each PTC linear's
``x @ W_effᵀ``, the MoE router) and recomputes the rest, never an
allocation.  On smoke configs (two periods, k = 8), on the CPU, from the
port's seeded parameters handed to both packages:

* the loss and every gradient leaf under "dots" are bit-equal to "full"
  and "none", in fused and blocked mode, with sampling masks, and with the
  chunked attention's own per-chunk checkpoint nested inside;
* olmo-1b's match the reference's "dots" within 1e-5;
* in fused mode the backward runs no 2-D product of a period body under
  "dots" (as many ``aten.mm`` as "none"), and all of them under "full";
  in blocked mode the plain ``ptc_block_matmul`` runs twice a linear
  under "full" and "dots" and once under "none";
* what "dots" keeps beyond "full", against the reference's residuals
  (``print_saved_residuals``): the same products in the MoE config (q,
  k, v, o and the router in fused mode, the router alone in blocked
  mode) and in blocked olmo-1b (none); in fused olmo-1b the reference's
  six a period (q, k, v, o, gate, up) and the period's last product, the
  MLP's down projection.  The reference drops that output because no
  backward reads it; PyTorch's recompute has to re-enter that linear to
  reach its residuals, and the kept output spares it the product.
"""

import collections
import contextlib
import dataclasses
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm_util import at, cfgs, leaves, lm_inputs, rel, split_batch
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.core import subspace
from repro_torch.core.sparsity import SparsityConfig
from repro_torch.kernels import ref
from repro_torch.models import lm as tlm

TOL = 1e-5
CASES = [("olmo-1b", "fused"), ("olmo-1b", "blocked"),
         ("qwen3-moe-30b-a3b", "fused"), ("qwen3-moe-30b-a3b", "blocked")]
N_PERIODS = 2
N_LIN = 7                   # q, k, v, o, gate, up, down a dense period


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def model(name, mode):
    """(reference cfg, port cfg, reference params, port params): the
    port's seeded init, and the same arrays as the reference's tree."""
    jc, tc = cfgs(name, mode)
    tp = tlm.init_model(torch.Generator().manual_seed(0), tc)

    def to_jax(tree):
        return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(
            v.numpy()) for k, v in tree.items()}
    return jc, tc, to_jax(tp), tp


def _policy(cfg, policy, chunk=None):
    return dataclasses.replace(cfg, remat=True, remat_policy=policy,
                               attn_chunk=chunk)


class _Ops(TorchDispatchMode):
    """Counts every aten op that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("chunk", [None, 4])
@pytest.mark.parametrize("name,mode", CASES)
def test_dots_changes_no_bit(name, mode, chunk):
    """Loss and gradients, sampling masks drawn from one seed: "dots" is
    "full" and "none" bit for bit (chunk 4: the chunked attention's
    per-chunk checkpoint nested inside the period's)."""
    _, tc, _, tp = model(name, mode)
    _, tb = split_batch(lm_inputs(tc, seed=3))
    # column sampling only where every PTC linear reads the B·S tokens
    scfg = SparsityConfig(alpha_w=0.6,
                          alpha_c=0.6 if name == "olmo-1b" else 1.0)
    out = {}
    for policy in ("full", "dots", "none"):
        step = tlm.build_train_step(_policy(tc, policy, chunk), scfg)
        out[policy] = step(tp, tb, torch.Generator().manual_seed(9))
    for policy in ("full", "none"):
        assert torch.equal(out["dots"][0], out[policy][0]), policy
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(out["dots"][1]), leaves(out[policy][1]))), policy


@pytest.mark.parametrize("mode", ["fused", "blocked"])
def test_dots_matches_reference(mode):
    name = "olmo-1b"
    jc, tc, jp, tp = model(name, mode)
    jb, tb = split_batch(lm_inputs(jc, seed=4))
    jloss, jg = jax.jit(jlm.build_train_step(_policy(jc, "dots")))(
        jp, jb, jax.random.PRNGKey(0))
    tloss, tg = tlm.build_train_step(_policy(tc, "dots"))(tp, tb)
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    n = 0
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        t = at(tg, path)
        assert tuple(t.shape) == tuple(g.shape), path
        if g.ndim == 0:                   # a frozen base's placeholder
            continue
        assert rel(t, g) < TOL, (path, rel(t, g))
        n += 1
    assert n > 0


def _backward_ops(monkeypatch, tc, tp, tb, policy) -> collections.Counter:
    """The aten ops of one train step's backward (``autograd.grad``)."""
    got = []
    grad = torch.autograd.grad

    def counted(*args, **kwargs):
        with _Ops() as ops:
            out = grad(*args, **kwargs)
        got.append(ops.n)
        return out

    monkeypatch.setattr(torch.autograd, "grad", counted)
    tlm.build_train_step(_policy(tc, policy))(tp, tb)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    assert len(got) == 1
    return got[0]


def test_fused_dots_recomputes_no_product(monkeypatch):
    _, tc, _, tp = model("olmo-1b", "fused")
    _, tb = split_batch(lm_inputs(tc, seed=3))
    mm = {policy: _backward_ops(monkeypatch, tc, tp, tb, policy)[
              torch.ops.aten.mm.default]
          for policy in ("full", "dots", "none")}
    assert mm["dots"] == mm["none"] > 0
    assert mm["full"] == mm["none"] + N_PERIODS * N_LIN


def test_blocked_dots_reruns_the_forward(monkeypatch):
    _, tc, _, tp = model("olmo-1b", "blocked")
    _, tb = split_batch(lm_inputs(tc, seed=3))
    calls = collections.Counter()

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("ptc_block_matmul", "sigma_grad", "feedback_matmul"):
        monkeypatch.setattr(subspace, name, counting(
            name, getattr(ref, name + "_ref")))
    n = N_PERIODS * N_LIN
    for policy, fwd in (("full", 2 * n), ("dots", 2 * n), ("none", n)):
        calls.clear()
        tlm.build_train_step(_policy(tc, policy))(tp, tb)
        assert calls == {"ptc_block_matmul": fwd, "sigma_grad": n,
                         "feedback_matmul": n}, (policy, calls)


def _reference_extra(jc, jp, jb) -> list:
    """The sizes of the residuals the reference's "dots" keeps beyond its
    "full", one entry a period (its residuals stack the periods)."""
    mask = jlayers.trainable_mask(jp)
    tr, fr = jlayers.partition(jp, mask)
    shapes = {}
    for policy in ("full", "dots"):
        cfg = _policy(jc, policy)

        def loss(tr):
            logits, aux = jlm.forward(jlayers.combine(tr, fr, mask), cfg, jb)
            return jlm.cross_entropy(logits, jb["labels"]) + aux

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            print_saved_residuals(loss, tr)
        shapes[policy] = collections.Counter(
            tuple(int(d) for d in m.group(1).split(",") if d)
            for m in re.finditer(r"^\w+\[([\d,]*)\]", buf.getvalue(), re.M))
    extra = shapes["dots"] - shapes["full"]
    assert not shapes["full"] - shapes["dots"]
    sizes = []
    for shape, n in extra.items():
        assert shape[0] == N_PERIODS
        sizes += [int(np.prod(shape[1:]))] * (n * N_PERIODS)
    return sorted(sizes)


@pytest.mark.parametrize("name,mode", CASES)
def test_dots_keeps_the_reference_residuals(monkeypatch, name, mode):
    jc, tc, jp, tp = model(name, mode)
    jb, tb = split_batch(lm_inputs(jc, seed=3))
    kept = []

    def recording(ctx, func, *args, **kwargs):
        policy = tlm._dots_policy(ctx, func, *args, **kwargs)
        if not ctx.is_recompute \
                and policy == tlm.CheckpointPolicy.MUST_SAVE:
            kept.append(ctx.op_output.numel())
        return policy

    monkeypatch.setattr(tlm, "_DOTS_CONTEXT", functools.partial(
        tlm.create_selective_checkpoint_contexts, recording))
    tlm.build_train_step(_policy(tc, "dots"))(tp, tb)
    want = _reference_extra(jc, jp, jb)
    if (name, mode) == ("olmo-1b", "fused"):
        # the period's last product, the MLP's down projection: B·S rows
        # of d_model
        want = sorted(want + [tb["tokens"].numel() * tc.d_model] * N_PERIODS)
        assert len(want) == N_PERIODS * N_LIN
    assert sorted(kept) == want
    if mode == "fused":
        assert kept
