"""Port parity: the MoE half of ``repro_torch.models.ffn`` (``MoECfg``,
``init_moe``, ``moe``: routing, top-k, capacity, the stable-sort
dispatch, the batched experts, the gate-weighted combine) against
``repro.models.ffn`` on the CPU.

Parameters come from the reference's ``init_moe`` and are carried over
with ``convert.lm_params``; inputs are made with numpy from a seed and
given to both sides in one dtype, so both route from the same fp32
router logits.  Errors are relative to the largest entry of the
reference output; the aux loss is compared the same way.

* decode (s = 1, E = 128, top-8; cap 1, nothing dropped), fp32: 1e-5;
* prefill-sized groups (B 2, S 16, E 4, top-2; cap 10, which some
  experts overflow), fp32: 1e-5, and equal (1e-5) to a dense combine of
  each token's experts with the overflowing assignments' gates zeroed;
* decode against the dense combine, nothing dropped: 1e-5;
* a planted three-way tie in the router: selection and order as
  ``jax.lax.top_k`` (lower index first), output within 1e-5;
* ``dispatch="a2a"`` on one device: the same result as ``"pjit"``,
  bitwise in the port, and within 1e-5 of the reference's a2a;
* blocked-mode experts (one PTC linear per expert): 1e-5;
* bf16 bases: 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro_torch import convert
from repro_torch.models import ffn as tffn
from repro_torch.models import layers as tlayers

TOL = 1e-5
BF16_TOL = 2e-2
D, DFF = 32, 48


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _layer(e, k, bf16=False, mode="fused", dispatch="pjit", seed=0):
    jlin = jlayers.PTCLinearCfg(
        k=8, mode=mode, base_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tlin = tlayers.PTCLinearCfg(
        k=8, mode=mode, base_dtype=torch.bfloat16 if bf16 else torch.float32)
    kw = dict(d_model=D, d_ff=DFF, n_experts=e, top_k=k, dispatch=dispatch)
    jcfg, tcfg = jffn.MoECfg(**kw), tffn.MoECfg(**kw)
    jp = jffn.init_moe(jax.random.PRNGKey(seed), jcfg, jlin)
    return jcfg, tcfg, jlin, tlin, jp, convert.lm_params(jp)


def _run(jcfg, tcfg, jlin, tlin, jp, tp, x):
    dt = jlin.base_dtype
    jy, jaux = jax.jit(jffn.moe, static_argnums=(1, 2))(
        jp, jcfg, jlin, jnp.asarray(x, dt))
    ty, taux = tffn.moe(tp, tcfg, tlin,
                        torch.from_numpy(x).to(tlin.base_dtype))
    assert ty.dtype == tlin.base_dtype and taux.dtype == torch.float32
    return (jy, jaux), (ty, taux)


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _capacity(s, k, e):
    return min(s * k, max(1, int(s * k / e * 1.25)))


def test_init_moe_tree_matches_reference():
    _, tcfg, _, tlin, jp, tp = _layer(4, 2)
    mine = tffn.init_moe(torch.Generator().manual_seed(0), tcfg, tlin)
    want = {k: (tuple(a.shape), str(a.dtype)) for k, a in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for k, a in jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert got == want
    assert tuple(mine["experts"]["gate"]["u"].shape) == (4, 6, 4, 8, 8)
    assert mine["router"].dtype == torch.float32
    # the carried tree is the reference's, value for value
    np.testing.assert_array_equal(tp["experts"]["down"]["v"].numpy(),
                                  np.asarray(jp["experts"]["down"]["v"]))


@pytest.mark.parametrize("bf16", [False, True])
def test_decode_matches_reference(bf16):
    """s = 1, E = 128, top-8: cap = 1, each token's 8 experts distinct."""
    layer = _layer(128, 8, bf16=bf16)
    assert _capacity(1, 8, 128) == 1
    (jy, jaux), (ty, taux) = _run(*layer, _x((3, 1, D)))
    tol = BF16_TOL if bf16 else TOL
    assert _rel(ty, jy) < tol
    assert _rel(taux, jaux) < TOL


def _dense_combine(tp, tcfg, tlin, x, idx, gates):
    """Each token's chosen experts applied directly through ``mlp`` (one
    expert's PTC linears at a time), gate-weighted and summed."""
    xt = torch.from_numpy(x)
    y = torch.zeros_like(xt)
    fcfg = tffn.FFNCfg(tcfg.d_model, tcfg.d_ff, tcfg.act)
    for e in range(tcfg.n_experts):
        ye = tffn.mlp(tlayers.tree_map(lambda a: a[e], tp["experts"]), fcfg,
                      tlin, xt)
        y += ((idx == e) * gates).sum(-1)[..., None] * ye
    return y


@pytest.mark.parametrize("bf16", [False, True])
def test_prefill_groups_with_capacity_overflow_match_reference(bf16):
    layer = _layer(4, 2, bf16=bf16)
    (jy, jaux), (ty, taux) = _run(*layer, _x((2, 16, D)))
    assert _rel(ty, jy) < (BF16_TOL if bf16 else TOL)
    assert _rel(taux, jaux) < TOL


def test_overflowing_assignments_are_dropped():
    """Within a group, each expert keeps its first ``cap`` assignments in
    (token, rank) order; the rest add nothing.  The output equals the
    dense combine with the dropped gates zeroed."""
    jcfg, tcfg, jlin, tlin, jp, tp = layer = _layer(4, 2)
    x = _x((2, 16, D))
    b, s, k = 2, 16, 2
    cap = _capacity(s, k, 4)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"].T, -1)
    gates, idx = tffn._top_k(probs, k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    kept = np.ones((b, s * k), bool)
    for g in range(b):
        for e in range(4):
            kept[g, np.flatnonzero(idx[g].reshape(-1).numpy() == e)[cap:]] = \
                False
    assert not kept.all()                       # some expert overflows
    kept = torch.from_numpy(kept.reshape(b, s, k))
    (jy, _), (ty, _) = _run(*layer, x)
    want = _dense_combine(tp, tcfg, tlin, x, idx, gates * kept)
    assert _rel(ty, want.numpy()) < TOL
    assert _rel(ty, jy) < TOL
    full = _dense_combine(tp, tcfg, tlin, x, idx, gates)
    assert _rel(ty, full.numpy()) > 1e-2        # the drop shows


def test_decode_dispatch_equals_the_dense_combine():
    """At decode nothing is dropped: the dispatch equals each token's
    top-k experts applied directly (the check the card repeats at
    qwen3-moe-30b-a3b's full width)."""
    _, tcfg, _, tlin, _, tp = _layer(16, 4)
    x = _x((5, 1, D))
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"].T, -1)
    gates, idx = tffn._top_k(probs, 4)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    got, _ = tffn.moe(tp, tcfg, tlin, torch.from_numpy(x))
    want = _dense_combine(tp, tcfg, tlin, x, idx, gates)
    assert _rel(got, want.numpy()) < TOL


def test_top_k_ties_follow_lax_top_k():
    probs = np.asarray([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25,
                                                    0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tffn._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_planted_router_tie_matches_reference():
    """Experts 1, 2 and 3 share one router row, expert 0 has its negation:
    every token's probabilities tie three ways, and the tie decides which
    experts serve it (top-2: {1, 2} where the shared row wins, {0, 1}
    where it loses) and which gate comes first (the aux loss's top-1)."""
    jcfg, tcfg, jlin, tlin, jp, tp = _layer(4, 2)
    row = np.array(jp["router"][1])
    router = np.stack([-row, row, row, row])
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router.copy()))
    x = _x((2, 16, D), seed=3)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"].T, -1)
    assert torch.equal(probs[..., 1], probs[..., 2])
    _, idx = tffn._top_k(probs, 2)
    wins = (torch.from_numpy(x) @ torch.from_numpy(row)) > 0
    assert wins.any() and (~wins).any()
    assert torch.equal(idx[wins], torch.tensor([1, 2]).expand(
        int(wins.sum()), 2))
    assert torch.equal(idx[~wins], torch.tensor([0, 1]).expand(
        int((~wins).sum()), 2))
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jlin, tlin, jp, tp, x)
    assert _rel(ty, jy) < TOL
    assert _rel(taux, jaux) < TOL


def test_a2a_dispatch_is_the_group_wise_path_on_one_device():
    jcfg, tcfg, jlin, tlin, jp, tp = _layer(4, 2, dispatch="a2a")
    x = _x((2, 8, D))
    (jy, jaux), (ty, taux) = _run(jcfg, tcfg, jlin, tlin, jp, tp, x)
    assert _rel(ty, jy) < TOL and _rel(taux, jaux) < TOL
    py, paux = tffn.moe(tp, dataclasses.replace(tcfg, dispatch="pjit"),
                        tlin, torch.from_numpy(x))
    assert torch.equal(py, ty) and torch.equal(paux, taux)


def test_blocked_experts_match_reference():
    layer = _layer(4, 2, mode="blocked")
    (jy, jaux), (ty, taux) = _run(*layer, _x((2, 8, D)))
    assert _rel(ty, jy) < TOL and _rel(taux, jaux) < TOL
