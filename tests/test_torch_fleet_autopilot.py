"""Port parity: the ``fleet_autopilot`` benchmark
(``repro_torch.benchmarks.fleet_autopilot``) on the CPU.

* Its weights and the day's schedule are the reference's numpy draws,
  bitwise, and ``logit_sensitivity`` gives the reference's weights and
  ranking for them (the duel's two tenants and the calibration's three).
* The gateway leg (smoke:qwen3-4b, ``--hw-logits --autopilot``,
  ``accuracy_aware``, 2 chips of k = 8, σ_drift 0.008) completes every
  request's tokens, with the gateway's occupancy reaching the autopilot's
  load forecast (load samples > 0) and every layer call accounted.
* The runner knows the benchmark by the reference's name.
"""

import numpy as np
import pytest
import torch

from benchmarks import fleet_autopilot as jfa
from repro.runtime.autopilot import logit_sensitivity as j_sensitivity
from repro_torch.benchmarks import fleet_autopilot as tfa
from repro_torch.benchmarks import run as bench_run
from repro_torch.runtime.autopilot import logit_sensitivity


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and the port's many small ops then wait at every parallel
    region on threads the other workers hold (a 3 s run took 139 s)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_draws_equal_the_reference():
    for a, b in zip(tfa.tenant_weights(), jfa._tenant_weights()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tfa._schedule(240), jfa._schedule(240)):
        if isinstance(a, dict):
            assert a == b
        else:
            assert np.array_equal(a, b)


def test_logit_sensitivity_ranks_as_the_reference():
    rng = np.random.default_rng(tfa.SEED + 9)
    calib = [np.asarray(rng.standard_normal((tfa.DIM, tfa.DIM))
                        / np.sqrt(tfa.DIM) * s, np.float32)
             for s in (0.6, 1.0, 1.8)]
    for weights in (tfa.tenant_weights(), calib):
        got, want = logit_sensitivity(weights), j_sensitivity(weights)
        assert np.allclose(got, want, rtol=1e-12, atol=0)
        assert list(np.argsort(got)) == list(np.argsort(want))


def test_gateway_leg_completes_with_load_samples():
    gw = tfa.gateway_leg("cpu")
    assert gw["complete"] and gw["tokens_out"] == gw["expected_tokens"]
    assert gw["autopilot"]["load_samples"] > 0
    hw = gw["hw"]
    assert hw["mode"] == "route" and hw["hw_calls"] > 0
    assert hw["hw_calls"] + hw["shadow_calls"] == hw["layers"] * hw["steps"]


def test_runner_registers_the_benchmark():
    assert ("fleet_autopilot", tfa.main) in bench_run.RUNTIME
    assert ("fleet_autopilot", tfa.main) in bench_run.BENCHES
