"""Port parity: ``repro_torch.data``'s streams against ``repro.data``'s.

The port keeps its own numpy copy of the reference's synthetic data
module: every batch of ``lm_batch_stream``, ``vision_stream``,
``transfer_vision`` and ``vowel_stream`` is byte-equal to the reference's
for several seeds and steps, and the reference's own data tests
(``tests/test_data.py``) hold for the port's functions.
"""

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro_torch.data as tdata


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/test_torch_hw_serve.py: under the
    suite's workers torch's parallel regions wait on threads other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


def test_exports_match_the_reference():
    assert sorted(tdata.synthetic.__all__) == sorted(jdata.synthetic.__all__)
    for name in jdata.synthetic.__all__:
        assert getattr(tdata, name) is getattr(tdata.synthetic, name), name


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_lm_batch_stream_bytes(seed):
    got = list(tdata.lm_batch_stream(seed, 4, 32, 256, 5))
    want = list(jdata.lm_batch_stream(seed, 4, 32, 256, 5))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("seed", [0, 2, 9])
@pytest.mark.parametrize("kw", [{}, {"noise": 0.3}, {"rot_classes": True}])
def test_vision_stream_bytes(seed, kw):
    got = list(tdata.vision_stream(seed, 16, (6, 6, 1), 5, 4, **kw))
    want = list(jdata.vision_stream(seed, 16, (6, 6, 1), 5, 4, **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("seed,step", [(0, 0), (1, 7), (5, 3)])
def test_transfer_vision_bytes(seed, step):
    # the onchip_transfer example's geometry (36 features, 9 classes)
    _same(tdata.transfer_vision(seed, step, 64, (36,), 9, noise=2.2),
          jdata.transfer_vision(seed, step, 64, (36,), 9, noise=2.2))


@pytest.mark.parametrize("seed", [0, 4])
def test_vowel_stream_bytes(seed):
    got = list(tdata.vowel_stream(seed, 16, 3))
    want = list(jdata.vowel_stream(seed, 16, 3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same(g, w)


# -- tests/test_data.py's assertions, run against the port -------------------


def test_lm_batch_deterministic():
    b1 = tdata.lm_batch(0, 5, 4, 32, 256)
    b2 = tdata.lm_batch(0, 5, 4, 32, 256)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = tdata.lm_batch(0, 6, 4, 32, 256)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_lm_batch_markov_structure():
    """Next-token entropy is ~log2(branch) ≪ log2(vocab) — learnable."""
    b = tdata.lm_batch(0, 0, 64, 128, 256)
    toks, labels = b["tokens"], b["labels"]
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    succ = {}
    for row_t, row_l in zip(toks.reshape(-1, 128), labels.reshape(-1, 128)):
        for c, n in zip(row_t, row_l):
            succ.setdefault(int(c), set()).add(int(n))
    assert max(len(v) for v in succ.values()) <= 4


def test_vision_labels_and_shapes():
    b = tdata.synthetic_vision(0, 0, 32, (8, 8, 1), 4)
    assert b["x"].shape == (32, 8, 8, 1)
    assert b["y"].shape == (32,) and b["y"].max() < 4
    b2 = tdata.synthetic_vision(0, 1, 512, (8, 8, 1), 4, noise=0.1)
    m0 = b2["x"][b2["y"] == 0].mean(0).ravel()
    m1 = b2["x"][b2["y"] == 1].mean(0).ravel()
    assert np.linalg.norm(m0 - m1) > 1.0    # classes separable


def test_transfer_task_differs():
    a = tdata.synthetic_vision(0, 0, 16, (4, 4, 1), 4, noise=0.0)
    b = tdata.transfer_vision(0, 0, 16, (4, 4, 1), 4, noise=0.0)
    assert not np.allclose(a["x"], b["x"])


def test_vowel_stream():
    batches = list(tdata.vowel_stream(0, 16, 3))
    assert len(batches) == 3
    assert batches[0]["x"].shape == (16, 8)
