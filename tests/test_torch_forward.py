"""Port parity: ``repro_torch.models.lm.forward`` — the training / prefill
forward of every family (dense, MoE, ssm, hybrid, vlm, encdec) — against
``repro.models.lm.forward`` on the CPU.

Parameters come from the reference's ``init_model`` and are carried over
with ``convert.lm_params``; tokens, encdec frames and vlm image tokens are
made with numpy from a seed and given to both sides in one dtype.  Errors
are relative to the largest entry of the reference output.

* logits and the MoE aux loss of all ten smoke archs in fused mode: 1e-5;
* blocked mode (the PTC kernels' dataflow) for olmo-1b, whisper-base and
  llama-3.2-vision-11b: 1e-5;
* bf16 bases, blocked (olmo-1b, whisper-base): 2e-2, the families' bf16
  limit;
* whisper's encoder over frames of another length than the decoder's
  tokens: 1e-5;
* ``launch.steps.build_prefill_step``: the last position's logits.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_lm_util import B, S, lm_inputs, model, rel, split_batch
from repro.configs import ARCH_NAMES
from repro.launch.steps import build_prefill_step as j_build_prefill_step
from repro.models import lm as jlm
from repro_torch.launch.steps import build_prefill_step
from repro_torch.models import lm as tlm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5
BF16_TOL = 2e-2


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_matches_reference(name):
    """Logits and aux loss of every smoke arch from one converted state,
    fused mode."""
    jc, tc, jp, tp = model(name)
    jb, tb = split_batch(lm_inputs(jc))
    jl, ja = jlm.forward(jp, jc, jb)
    with torch.no_grad():
        tl, ta = tlm.forward(tp, tc, tb)
    assert tl.shape == (B, S, jc.vocab)
    assert rel(tl, jl) < TOL
    assert abs(float(ta) - float(ja)) <= TOL * max(1.0, abs(float(ja)))


@pytest.mark.parametrize("name", ["olmo-1b", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_blocked_forward_matches_reference(name):
    jc, tc, jp, tp = model(name, "blocked")
    jb, tb = split_batch(lm_inputs(jc, seed=1))
    with torch.no_grad():
        tl, _ = tlm.forward(tp, tc, tb)
    assert rel(tl, jlm.forward(jp, jc, jb)[0]) < TOL


@pytest.mark.parametrize("name", ["olmo-1b", "whisper-base"])
def test_forward_with_bf16_bases_matches_reference(name):
    jc, tc, jp, tp = model(name, "blocked", bf16=True)
    jb, tb = split_batch(lm_inputs(jc, seed=2), bf16=True)
    with torch.no_grad():
        tl, _ = tlm.forward(tp, tc, tb)
    assert tl.dtype == torch.bfloat16
    assert rel(tl, jlm.forward(jp, jc, jb)[0]) < BF16_TOL


def test_forward_encoder_frames_of_another_length():
    """whisper's encoder reads frames of their own length; the decoder
    cross-attends to all of them."""
    jc, tc, jp, tp = model("whisper-base")
    jb, tb = split_batch(lm_inputs(jc, seed=3, frames=24))
    with torch.no_grad():
        tl, _ = tlm.forward(tp, tc, tb)
    assert rel(tl, jlm.forward(jp, jc, jb)[0]) < TOL


@pytest.mark.parametrize("name", ["qwen3-4b", "llama-3.2-vision-11b"])
def test_prefill_step_matches_reference(name):
    jc, tc, jp, tp = model(name)
    raw = lm_inputs(jc, seed=4)
    del raw["labels"]
    jb, tb = split_batch(raw)
    want = j_build_prefill_step(jc)(jp, jb)
    got = build_prefill_step(tc)(tp, tb)
    assert got.shape == (B, jc.vocab) and rel(got, want) < TOL
