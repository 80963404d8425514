"""Request queue + continuous-batching admission scheduler.

The port's own copy of ``repro/serving/scheduler.py`` (pure numpy): the
same seed gives the same requests, and the same submissions the same
admission trace, as the reference.

The scheduler owns *which request runs in which slot when*; the engine
owns the math.  Policy:

* **Strict FIFO admission** — requests are admitted in submission
  order, never bypassed.  A large request at the queue head blocks
  later small ones until capacity frees up; in exchange no request can
  starve (the property suite locks this).
* **Reserve-at-admission** — admission requires a free slot AND the
  request's whole-lifetime page reservation
  (``ceil((prompt+max_new)/page_size)``), so an admitted request never
  preempts or OOMs mid-flight.
* **Evict-on-completion** — a request leaves its slot the step it
  finishes (EOS emitted, or ``max_new`` reached); pages return to the
  free list the same step and the next queued request can take the
  slot on the *next* admission scan.

Everything is deterministic given the submission order: the event
``trace`` reproduces bit-for-bit under a fixed seed (property-tested).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np

from .kv_pages import PagedKVPool

__all__ = ["Request", "Scheduler", "poisson_workload"]

FINISH_EOS = "eos"
FINISH_MAX_NEW = "max_new"


@dataclasses.dataclass
class Request:
    """One user request: a prompt to prefill, then greedy decode."""

    rid: int
    prompt: np.ndarray            # (L,) int32 token ids
    max_new: int                  # decode budget
    arrival: int = 0              # virtual step the request enters the queue
    eos_id: Optional[int] = None  # stop token (emitted token ends decode)

    # lifecycle (filled by the scheduler/engine)
    out_tokens: list = dataclasses.field(default_factory=list)
    submitted_step: int = -1
    admitted_step: int = -1
    first_token_step: int = -1
    finished_step: int = -1
    finish_reason: str = ""

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        """Cache positions a full-budget run writes."""
        return self.prompt_len + self.max_new

    @property
    def done(self) -> bool:
        return self.finished_step >= 0

    def latency(self) -> int:
        """Sojourn time in virtual steps (arrival → finish)."""
        return self.finished_step - self.arrival

    def ttft(self) -> int:
        """Time to first token in virtual steps (arrival → first
        emission): queueing wait + the whole prefill."""
        return self.first_token_step - self.arrival


def poisson_workload(seed: int, n_requests: int, rate: float, vocab: int,
                     prompt_len: tuple[int, int] = (4, 12),
                     max_new: tuple[int, int] = (4, 12),
                     eos_id: Optional[int] = None) -> list[Request]:
    """Synthetic open-loop arrival process: ``n_requests`` requests with
    exponential(1/rate) inter-arrival gaps (quantized to steps), seeded
    prompt tokens and uniform prompt/decode lengths.  Deterministic for
    a fixed seed — the benchmark's load axis."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        if rid > 0:
            t += rng.exponential(1.0 / max(rate, 1e-9))
        ln = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mn = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = rng.integers(0, vocab, size=(ln,)).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt, max_new=mn,
                           arrival=int(t), eos_id=eos_id))
    return out


class Scheduler:
    """Slot assignment over a :class:`PagedKVPool`."""

    def __init__(self, pool: PagedKVPool):
        self.pool = pool
        self.n_slots = pool.n_slots
        self.pending: collections.deque[Request] = collections.deque()
        self.running: list[Optional[Request]] = [None] * self.n_slots
        self.finished: list[Request] = []
        self.trace: list[tuple] = []   # (step, event, rid, slot)

    # -- queue side ----------------------------------------------------------

    def submit(self, req: Request, step: int) -> None:
        req.submitted_step = step
        self.pending.append(req)
        self.trace.append((step, "submit", req.rid, -1))

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.running)

    @property
    def idle(self) -> bool:
        return not self.pending and self.n_active == 0

    # -- admission / eviction ------------------------------------------------

    def admit(self, step: int) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots, strict FIFO: stop at
        the first request that doesn't fit (slot or pages) — later
        requests never jump the queue."""
        admitted = []
        while self.pending:
            req = self.pending[0]
            if req.total_tokens > self.pool.cfg.max_tokens_per_slot:
                raise ValueError(
                    f"request {req.rid} needs {req.total_tokens} cache "
                    f"positions > slot capacity "
                    f"{self.pool.cfg.max_tokens_per_slot}")
            slot = next((i for i, r in enumerate(self.running)
                         if r is None), None)
            if slot is None or not self.pool.can_reserve(req.total_tokens):
                break
            self.pending.popleft()
            self.pool.reserve(slot, req.total_tokens)
            self.running[slot] = req
            req.admitted_step = step
            admitted.append((slot, req))
            self.trace.append((step, "admit", req.rid, slot))
        return admitted

    def finish(self, slot: int, step: int, reason: str) -> Request:
        req = self.running[slot]
        assert req is not None
        req.finished_step = step
        req.finish_reason = reason
        self.pool.free(slot)
        self.running[slot] = None
        self.finished.append(req)
        self.trace.append((step, "finish", req.rid, slot))
        return req
