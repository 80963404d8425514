"""Port: hardware-in-the-loop serving over the stream transports.

The port's ``launch.serve --hw-logits`` at the reference's ``hwtest`` arch
(one period, 7 PTC layers, fleet k = 8; ``tests/test_hw_serve.py``) on 2
chips, with every chip in process (``twin``), behind a server child over
pipes (``subprocess``) or over TCP (``socket``): the routed logits and the
tokens are bit-identical across the three, and so are every chip's PTC
calls, as ``tests/test_hw_serve.py:74-90`` requires of the reference.
"""

import argparse

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm

ARCH = tlm.ArchConfig(name="hwtest", family="dense", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=1, d_ff=48, vocab=64,
                      head_dim=16, remat=False,
                      ptc=tlayers.PTCLinearCfg(k=8,
                                               base_dtype=torch.float32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**over):
    base = dict(arch=ARCH, batch=2, prompt_len=3, gen=3, seed=5, fleet=2,
                drift=False, drift_sigma=0.0, probe_every=4, fleet_k=8,
                fleet_dim=8, fleet_tenants=1, fleet_driver="twin",
                hw_logits=True, hw_shadow=False, deploy_zo=False,
                no_recal=False, trace_logits=True, device="cpu")
    base.update(over)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def runs():
    return {d: serve.run(_args(fleet_driver=d))
            for d in ("twin", "subprocess", "socket")}


@pytest.mark.parametrize("transport", ["subprocess", "socket"])
def test_hw_logits_bit_identical_across_transports(runs, transport):
    ref, got = runs["twin"], runs[transport]
    np.testing.assert_array_equal(ref["logits"], got["logits"])
    np.testing.assert_array_equal(ref["gen"], got["gen"])
    for c1, c2 in zip(ref["report"]["chips"], got["report"]["chips"]):
        assert c1["ptc_calls"] == c2["ptc_calls"]
    hw_r, hw_g = ref["report"]["hw"], got["report"]["hw"]
    assert hw_g["frames"] == hw_r["frames"] > 0
    assert hw_g["hw_calls"] == hw_r["hw_calls"] > 0


def _fleet_cfg(kind: str):
    from repro_torch.runtime.demo import default_runtime_config
    return default_runtime_config(k=4, sigma_drift=0.0, probe_every=4,
                                  driver_kind=kind)


def test_stream_fleet_deploys_together_as_one_chip_after_another():
    """A stream fleet's chips deploy together (their server children start
    at once), from the draws one chip after another makes: the same
    commanded phases as the twin transport's fleet, and the generator
    left in the same state."""
    from repro_torch.runtime.fleet import make_fleet

    w = torch.randn((8, 8), generator=torch.Generator().manual_seed(3))
    gens, phases = {}, {}
    for kind in ("twin", "subprocess"):
        gens[kind] = torch.Generator().manual_seed(0)
        chips = make_fleet(gens[kind], 3, [w, 0.5 * w], _fleet_cfg(kind),
                           device="cpu")
        try:
            phases[kind] = [torch.cat(c.driver.read_phases(), -1)
                            for c in chips]
        finally:
            for c in chips:
                c.driver.close()
    assert torch.equal(gens["twin"].get_state(),
                       gens["subprocess"].get_state())
    for a, b in zip(phases["twin"], phases["subprocess"]):
        assert torch.equal(a, b)


def test_stream_fleet_closes_the_others_when_a_chip_fails(monkeypatch):
    from repro_torch.runtime import fleet

    made, make_chip = [], fleet.make_chip

    def failing(gen, chip_id, *a, **kw):
        if chip_id == 1:
            raise RuntimeError("planted deploy failure")
        chip = make_chip(gen, chip_id, *a, **kw)
        made.append(chip)
        return chip

    monkeypatch.setattr(fleet, "make_chip", failing)
    w = torch.randn((8, 8), generator=torch.Generator().manual_seed(3))
    with pytest.raises(RuntimeError, match="planted deploy failure"):
        fleet.make_fleet(torch.Generator().manual_seed(0), 2, w,
                         _fleet_cfg("subprocess"), device="cpu")
    assert len(made) == 1 and made[0].driver._proc is None
