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
