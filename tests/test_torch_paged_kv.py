"""Port parity: the paged KV cache — ``repro_torch.kernels.paged_kv`` (the
wrappers run their plain versions on the CPU) against the reference's
Pallas kernels in interpret mode, and the port's copies of
``serving/kv_pages.py`` and ``serving/scheduler.py`` against the
reference's.

* gather: bitwise equal to ``repro.kernels.ops.paged_gather``, fp32 and
  bf16, including the reference test's geometry.
* scatter: bitwise equal to ``paged_scatter_rows`` with distinct targets
  and with duplicate targets (the reference's sequential grid: the last
  row wins), in place.
* allocator and scheduler: a seeded admit/evict schedule gives the same
  page tables, lengths and event trace; ``poisson_workload`` the same
  requests for the same seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.serving import kv_pages as jkv
from repro.serving import scheduler as jsched
from repro_torch.kernels import paged_gather, paged_scatter, paged_scatter_rows
from repro_torch.kernels.ref import paged_scatter_ref
from repro_torch.serving import kv_pages as tkv
from repro_torch.serving import scheduler as tsched


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a tensor of ``dtype``."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
            torch.bfloat16)
    return jnp.asarray(a, jnp.float32), torch.from_numpy(a)


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n_pages,ps,d,b,j", [(10, 4, 6, 3, 2),
                                              (17, 8, 16, 5, 4)])
def test_gather_matches_reference_bitwise(dtype, n_pages, ps, d, b, j):
    rng = np.random.default_rng(0)
    jp, tp = _pair(rng.normal(size=(n_pages, ps, d)).astype(np.float32),
                   dtype)
    table = rng.integers(0, n_pages, size=(b, j)).astype(np.int32)
    want = ops.paged_gather(jnp.asarray(table), jp)
    got = paged_gather(torch.from_numpy(table), tp)
    assert got.dtype == tp.dtype and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), _np(want))


def _scatter_both(rng, n_pages, ps, d, idx, dtype):
    jp, tp = _pair(rng.normal(size=(n_pages, ps, d)).astype(np.float32),
                   dtype)
    jr, tr = _pair(rng.normal(size=(idx.shape[0], d)).astype(np.float32),
                   dtype)
    want = ops.paged_scatter_rows(jnp.asarray(idx), jr, jp)
    got = paged_scatter_rows(torch.from_numpy(idx), tr, tp)
    assert got is tp                                       # in place
    return _np(got), _np(want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_scatter_distinct_targets_matches_reference(dtype):
    rng = np.random.default_rng(1)
    idx = np.asarray([[2, 1], [5, 0], [2, 3]], np.int32)
    got, want = _scatter_both(rng, 8, 4, 5, idx, dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_scatter_duplicates_resolve_last_wins_as_reference(dtype):
    """The gateway parks every idle and padding row on one scratch
    target: the reference's sequential grid keeps the last."""
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, 3, 40), rng.integers(0, 2, 40)],
                   axis=1).astype(np.int32)
    idx[-5:] = (6, 0)                       # a scratch page, written 5 times
    got, want = _scatter_both(rng, 7, 4, 6, idx, dtype)
    np.testing.assert_array_equal(got, want)


def test_scatter_one_row_per_slot_matches_reference():
    rng = np.random.default_rng(3)
    pages = rng.normal(size=(6, 4, 3)).astype(np.float32)
    new = rng.normal(size=(4, 3)).astype(np.float32)
    idx = np.asarray([[1, 2], [5, 0], [5, 0], [0, 3]], np.int32)
    want = ops.paged_scatter(jnp.asarray(idx), jnp.asarray(new),
                             jnp.asarray(pages))
    got = paged_scatter(torch.from_numpy(idx), torch.from_numpy(new),
                        torch.from_numpy(pages.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_plain_version_refuses_targets_outside_the_pool():
    pages = torch.zeros((3, 2, 4))
    for bad in ([3, 0], [0, 2], [-1, 0]):
        with pytest.raises(ValueError, match="outside the pool"):
            paged_scatter_ref(torch.tensor([bad], dtype=torch.int32),
                              torch.ones((1, 4)), pages)


def test_gather_plain_version_refuses_ids_outside_the_pool():
    pages = torch.zeros((3, 2, 4))
    for bad in (3, -1):
        with pytest.raises(IndexError, match="outside the pool"):
            paged_gather(torch.tensor([[0, bad]], dtype=torch.int32), pages)


def test_wrappers_check_their_inputs():
    pages = torch.zeros((3, 2, 4))
    with pytest.raises(ValueError, match="int32"):
        paged_gather(torch.zeros((2, 2), dtype=torch.int64), pages)
    with pytest.raises(ValueError, match="rows must be"):
        paged_scatter(torch.zeros((2, 2), dtype=torch.int32),
                      torch.zeros((2, 4), dtype=torch.bfloat16), pages)


# ---------------------------------------------------------------------------
# allocator and scheduler copies
# ---------------------------------------------------------------------------


def _schedule(kv, sched, seed):
    """A seeded open-loop admit/evict schedule over one package's
    allocator and scheduler; returns (trace, tables, lens) per step."""
    rng = np.random.default_rng(seed)
    pool = kv.PagedKVPool(kv.PageConfig(page_size=4, n_pages=24,
                                        max_pages_per_slot=6), 3)
    s = sched.Scheduler(pool)
    reqs = [sched.Request(rid=i, prompt=np.zeros(int(rng.integers(1, 12)),
                                                 np.int32),
                          max_new=int(rng.integers(1, 10)),
                          arrival=int(rng.integers(0, 30)))
            for i in range(25)]
    reqs.sort(key=lambda r: (r.arrival, r.rid))
    pos, nxt, step, snaps = {}, 0, 0, []
    while nxt < len(reqs) or not s.idle:
        while nxt < len(reqs) and reqs[nxt].arrival <= step:
            s.submit(reqs[nxt], step)
            nxt += 1
        for _, req in s.admit(step):
            pos[req.rid] = 0
        for slot, req in list(enumerate(s.running)):
            if req is None:
                continue
            span = pool.write_span(slot, 2) if pool.lens[slot] + 2 <= \
                req.total_tokens else pool.write_span(slot, 1)
            pool.advance(slot, len(span))
            pos[req.rid] += len(span)
            if pos[req.rid] >= req.total_tokens:
                s.finish(slot, step, "max_new")
        pool.check_invariants()
        snaps.append((pool.table.copy(), pool.lens.copy(), pool.free_pages))
        step += 1
    return s.trace, snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_scheduler_copies_match_reference(seed):
    jtrace, jsnaps = _schedule(jkv, jsched, seed)
    ttrace, tsnaps = _schedule(tkv, tsched, seed)
    assert ttrace == jtrace and len(jtrace) > 50
    assert len(tsnaps) == len(jsnaps)
    for (jt, jl, jf), (tt, tl, tf) in zip(jsnaps, tsnaps):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        assert tf == jf


@pytest.mark.parametrize("seed,rate,eos", [(0, 0.5, None), (7, 2.0, 3)])
def test_poisson_workload_matches_reference(seed, rate, eos):
    kw = dict(prompt_len=(3, 40), max_new=(2, 9), eos_id=eos)
    want = jsched.poisson_workload(seed, 20, rate, 500, **kw)
    got = tsched.poisson_workload(seed, 20, rate, 500, **kw)
    assert [(r.rid, r.arrival, r.max_new, r.eos_id) for r in got] == \
        [(r.rid, r.arrival, r.max_new, r.eos_id) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.prompt, w.prompt)
