"""Port parity: the training driver's parts — ``launch.train``,
``checkpoint.ckpt`` and ``optim.schedules`` — on the CPU.

* ``launch.train.main`` at ``smoke:olmo-1b`` with ``--device cpu``: the
  loss falls, a restart resumes from the last checkpoint (as
  ``tests/test_system.py`` runs the reference's driver), SMD skips
  iterations, the deadline logs late steps, and without ``--device`` the
  driver asks for CUDA and raises here;
* checkpoints, as ``tests/test_checkpoint.py`` checks the reference's: a
  round trip (bf16 leaves bit-exact, an ``OptState`` with its integer
  step), keep-last-k, no temporary directory left, a specific step, the
  manager's cadence and resume, nothing to restore in an empty
  directory; the archive's keys are the reference's "/"-joined paths; the
  manager's SIGTERM flag lasts only while it is open, and the driver
  leaves the process's handler as it found it;
* the schedules against the reference's at steps 0-40: 1e-6.
"""

import argparse
import os
import signal

import numpy as np
import pytest
import torch

from repro.optim import schedules as jsched
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.launch import train
from repro_torch.optim import schedules as tsched
from repro_torch.optim.optimizers import OptState


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGS = ["--arch", "smoke:olmo-1b", "--device", "cpu", "--batch", "8",
        "--seq", "32", "--lr", "5e-3", "--log-every", "5"]


def test_driver_loss_falls_and_resumes(tmp_path, capsys):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "10"]
    first = train.train(train.arg_parser().parse_args(
        ARGS + ck + ["--steps", "30"]))
    assert first["steps_run"] == 30 and first["resumed_from"] is None
    assert np.mean(first["losses"][-5:]) < np.mean(first["losses"][:5]) - 0.5
    assert latest_step(str(tmp_path)) == 20
    # the restart resumes from step 20 and runs to 35
    again = train.train(train.arg_parser().parse_args(
        ARGS + ck + ["--steps", "35"]))
    assert again["resumed_from"] == 20 and again["steps_run"] == 14
    assert "resumed from step 20" in capsys.readouterr().out
    assert train.main(ARGS + ck + ["--steps", "36"]) == 0


def test_resumed_run_continues_the_uninterrupted_one(tmp_path):
    """A run stopped at a checkpoint and resumed takes the steps the
    uninterrupted run takes: the same losses after the resume point."""
    whole = train.train(train.arg_parser().parse_args(ARGS + ["--steps", "8"]))
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    train.train(train.arg_parser().parse_args(ARGS + ck + ["--steps", "5"]))
    rest = train.train(train.arg_parser().parse_args(ARGS + ck +
                                                  ["--steps", "8"]))
    assert rest["resumed_from"] == 4
    assert np.allclose(rest["losses"], whole["losses"][5:], rtol=1e-6)


def test_smd_skips_iterations():
    out = train.train(train.arg_parser().parse_args(
        ARGS + ["--steps", "20", "--alpha-d", "0.7", "--log-every",
                "100"]))
    assert out["skipped"] + out["steps_run"] == 20
    assert 5 <= out["skipped"] <= 19
    assert train.main(ARGS + ["--steps", "10", "--alpha-d", "0.99"]) == 0


def test_sampling_flags_and_deadline(capsys):
    out = train.train(train.arg_parser().parse_args(
        ARGS + ["--steps", "3", "--alpha-w", "0.5", "--alpha-c", "0.5",
                "--deadline-ms", "1e-6"]))
    assert out["late"] == [0, 1, 2] and np.isfinite(out["losses"]).all()
    assert "DEADLINE exceeded" in capsys.readouterr().out


def test_driver_puts_back_the_sigterm_handler(tmp_path):
    """A run with checkpoints catches SIGTERM only while it trains: after
    it the process's handler is the one it had before."""
    def mine(signum, frame):
        pass
    before = signal.signal(signal.SIGTERM, mine)
    try:
        train.train(train.arg_parser().parse_args(
            ARGS + ["--ckpt-dir", str(tmp_path), "--steps", "2"]))
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, before)


def test_driver_defaults_to_cuda(monkeypatch):
    """Without ``--device`` the driver runs on ``cuda``, and a host without
    CUDA raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "smoke:olmo-1b", "--steps", "1"])


# -- checkpoints -------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 4), generator=g),
            "nest": {"b": torch.arange(6, dtype=torch.int32),
                     "c": torch.tensor(float(seed)),
                     "h": torch.randn((3, 5), generator=g).to(
                         torch.bfloat16)}}


def _flat(tree):
    for _, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield v


def test_roundtrip_is_bit_exact(tmp_path):
    t = _tree(3)
    opt = OptState(step=7, mu=[torch.ones(2)], nu=[torch.zeros(())],
                   master=[torch.full((2,), 0.5)])
    save_checkpoint(str(tmp_path), 7, (t, opt), {"note": "x"})
    like = ({"a": torch.zeros(4, 4),
             "nest": {"b": torch.zeros(6, dtype=torch.int32),
                      "c": torch.zeros(()),
                      "h": torch.zeros((3, 5), dtype=torch.bfloat16)}},
            OptState(step=0, mu=[torch.zeros(2)], nu=[torch.ones(())],
                     master=[torch.zeros(2)]))
    (rt, ropt), meta = restore_checkpoint(str(tmp_path), like)
    assert meta["step"] == 7 and meta["note"] == "x"
    for a, b in zip(_flat(t), _flat(rt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(ropt, OptState) and ropt.step == 7
    assert torch.equal(ropt.mu[0], opt.mu[0])
    assert torch.equal(ropt.master[0], opt.master[0])
    with np.load(os.path.join(tmp_path, "step_7", "arrays.npz")) as data:
        assert "0/nest/h" in data.files and "1/step" in data.files
        assert "1/mu/0" in data.files


def test_keep_last_k(tmp_path):
    t = _tree()
    for s in range(6):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]
    assert latest_step(str(tmp_path)) == 5


def test_atomic_no_tmp_left(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    assert not any(n.startswith("tmp") for n in os.listdir(tmp_path))
    # a half-written checkpoint (no meta.json) is not a step
    os.makedirs(tmp_path / "step_9")
    assert latest_step(str(tmp_path)) == 1


def test_restore_specific_step(tmp_path):
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, _tree(s), keep=5)
    r, meta = restore_checkpoint(str(tmp_path), _tree(), step=2)
    assert meta["step"] == 2 and float(r["nest"]["c"]) == 2.0
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _tree())


def test_manager_cadence_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=5, install_sigterm=False)
    t = _tree()
    saved = [s for s in range(12) if mgr.maybe_save(s, t, {"loss": 1.0})]
    assert saved == [0, 5, 10] and latest_step(str(tmp_path)) == 10
    restored, meta = mgr.restore_or_none(_tree(1))
    assert meta["step"] == 10 and torch.equal(restored["a"], t["a"])


def test_manager_preemption_and_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=100, install_sigterm=False)
    assert mgr.restore_or_none(_tree()) == (None, None)
    mgr._on_sigterm(15, None)
    assert mgr.preempted and mgr.maybe_save(3, _tree())
    assert latest_step(str(tmp_path)) == 3


def test_manager_sigterm_handler_lasts_while_open(tmp_path):
    """SIGTERM sets the flag while the manager is open; closing it puts
    back the handler it replaced."""
    before = signal.getsignal(signal.SIGTERM)
    mgr = CheckpointManager(str(tmp_path), every=100)
    handler = signal.getsignal(signal.SIGTERM)
    assert handler is not before
    handler(signal.SIGTERM, None)
    assert mgr.preempted and mgr.maybe_save(1, _tree())
    mgr.close()
    assert signal.getsignal(signal.SIGTERM) is before
    mgr.close()                 # a second close changes nothing
    assert signal.getsignal(signal.SIGTERM) is before


# -- schedules ---------------------------------------------------------------


def test_schedules_match_reference():
    for step in range(41):
        for got, want in (
                (tsched.cosine_schedule(step, 30, 0.1),
                 jsched.cosine_schedule(step, 30, 0.1)),
                (tsched.linear_warmup_cosine(step, 10, 30),
                 jsched.linear_warmup_cosine(step, 10, 30)),
                (tsched.linear_warmup_cosine(step, 0, 1, 0.2),
                 jsched.linear_warmup_cosine(step, 0, 1, 0.2)),
                (tsched.exponential_decay(step, 0.9, 4),
                 jsched.exponential_decay(step, 0.9, 4))):
            assert isinstance(got, float)
            assert abs(got - float(want)) <= 1e-6


def test_train_run_namespace_takes_a_config():
    """``train.train`` takes an ``ArchConfig`` as ``arch`` (the chip smoke
    script passes full-width configs this way)."""
    from repro_torch.configs import smoke_config
    ns = train.arg_parser().parse_args(ARGS + ["--steps", "2"])
    ns = argparse.Namespace(**{**vars(ns),
                               "arch": smoke_config("qwen3-4b")})
    out = train.train(ns)
    assert out["steps_run"] == 2
