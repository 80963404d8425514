"""Port parity: the Appendix-G cost model (``repro_torch.core.profiler``).

The structural cases of ``tests/test_profiler.py`` run on the port, and
every ``LayerCost`` / ``ModelCost`` field equals the reference's exactly
(pure Python on both sides) for ``vgg8_specs`` and ``resnet18_specs``
under the six Table-2 configurations, per layer and in total, as do the
specs themselves.
"""

import dataclasses

import pytest

from repro.core import profiler as jprof
from repro.core.sparsity import SparsityConfig as JSparsityConfig
from repro_torch.core.profiler import (LayerSpec, layer_cost, model_cost,
                                       vgg8_specs, resnet18_specs)
from repro_torch.core.sparsity import SparsityConfig


def test_dense_ratio_structure():
    """Dense training: E_∇Σ = 2·E_fwd (two reciprocal PTC passes), and
    E_∇x ≈ E_fwd (Table 2: 8.58 / 17.16 / 8.34)."""
    spec = LayerSpec("l", c_out=64, c_in_eff=64, n_cols=1024, k=9)
    c = layer_cost(spec, SparsityConfig())
    assert c.e_bwd_w == 2 * c.e_fwd
    assert abs(c.e_bwd_x - c.e_fwd) / c.e_fwd < 0.15


def test_feedback_sampling_scales_bwd_x():
    spec = LayerSpec("l", c_out=90, c_in_eff=90, n_cols=512, k=9)
    dense = layer_cost(spec, SparsityConfig())
    half = layer_cost(spec, SparsityConfig(alpha_w=0.5))
    assert abs(half.e_bwd_x / dense.e_bwd_x - 0.5) < 0.05
    assert half.e_fwd == dense.e_fwd              # forward untouched
    # time steps: accumulation path halves
    assert half.t_bwd_x < dense.t_bwd_x


def test_column_sampling_scales_bwd_w():
    spec = LayerSpec("l", c_out=64, c_in_eff=64, n_cols=1000, k=9)
    dense = layer_cost(spec, SparsityConfig())
    cs = layer_cost(spec, SparsityConfig(alpha_c=0.4))
    assert abs(cs.e_bwd_w / dense.e_bwd_w - 0.4) < 0.05


def test_data_sampling_scales_everything():
    spec = LayerSpec("l", c_out=64, c_in_eff=64, n_cols=1000, k=9)
    dense = layer_cost(spec, SparsityConfig())
    smd = layer_cost(spec, SparsityConfig(alpha_d=0.5))
    assert abs(smd.e_total / dense.e_total - 0.5) < 1e-6
    assert abs(smd.t_total / dense.t_total - 0.5) < 1e-6


def test_first_layer_no_error_feedback():
    spec = LayerSpec("l0", c_out=64, c_in_eff=27, n_cols=1000, k=9,
                     first_layer=True)
    c = layer_cost(spec, SparsityConfig())
    assert c.e_bwd_x == 0.0 and c.t_bwd_x == 0.0


def test_topk_load_imbalance_costs_latency():
    spec = LayerSpec("l", c_out=90, c_in_eff=90, n_cols=512, k=9)
    p, q = spec.grid
    balanced = layer_cost(spec, SparsityConfig(alpha_w=0.5))
    imbalanced = layer_cost(spec, SparsityConfig(alpha_w=0.5), max_path=p)
    assert imbalanced.t_bwd_x > balanced.t_bwd_x


def test_model_stacks():
    vgg = model_cost(vgg8_specs(batch=8), SparsityConfig())
    res = model_cost(resnet18_specs(batch=8), SparsityConfig())
    assert res.e_total > vgg.e_total      # ResNet-18 ≫ VGG-8 (Table 2)
    assert vgg.e_total > 0 and vgg.t_total > 0


# the six Table-2 configurations (benchmarks/sampling_table2.py), as
# SparsityConfig keyword arguments and the max_path override of the
# imbalanced topk row (None: the balanced default)
TABLE2 = [
    ("SL-baseline", {}, None),
    ("+feedback(a=0.6)", dict(alpha_w=0.4), None),
    ("+column(a=0.6)", dict(alpha_w=0.4, alpha_c=0.4), None),
    ("+data(a=0.5)", dict(alpha_w=0.4, alpha_c=0.4, alpha_d=0.5), None),
    ("RAD(spatial,a=0.85)", {}, None),
    ("topk-imbalanced(a=0.6)", dict(alpha_w=0.4, feedback_mode="topk"),
     "imbalanced"),
]
STACKS = [("vgg8", vgg8_specs, jprof.vgg8_specs),
          ("resnet18", resnet18_specs, jprof.resnet18_specs)]
FIELDS = [f.name for f in dataclasses.fields(jprof.LayerCost)] + [
    "e_total", "t_total"]


@pytest.mark.parametrize("stack,mine,ref", STACKS)
@pytest.mark.parametrize("batch,k", [(128, 9), (8, 16)])
def test_specs_equal_reference(stack, mine, ref, batch, k):
    got, want = mine(batch=batch, k=k), ref(batch=batch, k=k)
    assert [dataclasses.astuple(s) for s in got] == \
        [dataclasses.astuple(s) for s in want]
    assert [s.grid for s in got] == [s.grid for s in want]


@pytest.mark.parametrize("stack,mine,ref", STACKS)
@pytest.mark.parametrize("tag,kw,path", TABLE2, ids=[t[0] for t in TABLE2])
def test_costs_equal_reference(stack, mine, ref, tag, kw, path):
    specs, jspecs = mine(batch=128), ref(batch=128)
    cfg, jcfg = SparsityConfig(**kw), JSparsityConfig(**kw)
    max_path = None
    if path == "imbalanced":
        max_path = max(1, int(0.8 * max(s.grid[0] for s in specs)))
    for s, js in zip(specs, jspecs):
        got = layer_cost(s, cfg, max_path=max_path)
        want = jprof.layer_cost(js, jcfg, max_path=max_path)
        assert [getattr(got, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS], (s.name, tag)
    for iters in (1.0, 3.0):
        got = model_cost(specs, cfg, iters=iters, max_path=max_path)
        want = jprof.model_cost(jspecs, jcfg, iters=iters, max_path=max_path)
        assert [getattr(got, f) for f in FIELDS] == \
            [getattr(want, f) for f in FIELDS], (tag, iters)
    got = model_cost(specs, cfg, inference_only=True)
    want = jprof.model_cost(jspecs, jcfg, inference_only=True)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
