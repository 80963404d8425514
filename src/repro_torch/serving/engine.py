"""Continuous-batching gateway engine: lockstep decode over slot batches.

Counterpart of ``repro/serving/engine.py`` (digital serving).  One virtual
step = one batched forward over every active slot
(``models.lm.build_gateway_step``, or ``build_gateway_prefill_step`` with
``prefill_chunk`` > 1): page-assembled KV views in (``paged_gather``),
logits and new KV rows out, rows written back into the page pools
(``paged_scatter`` / ``paged_scatter_rows``).  Mamba positions (ssm and
hybrid archs, one-token path only) keep a dense per-slot SSM state
instead, passed whole into the step and replaced whole from its output;
an admitted slot's state is zeroed, and idle slots' states advance on
padding tokens until then, as the reference's do.  Admission, eviction
and paging policy live in ``scheduler`` / ``kv_pages``.

The step runs eagerly (the reference jits it).  The pools are updated in
place (the reference's scatter aliases them into its output).
Hardware-in-the-loop execution rides the
:class:`~repro_torch.runtime.hw_serve.HwServePlane` (``hw_plane``,
``build_gateway_hw_plane``): the gateway installs the plane's PTC hook
around its loop, so each layer's product for ALL in-flight requests ships
as one coalesced driver frame to the routed chip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.paged_kv import paged_gather, paged_scatter, paged_scatter_rows
from ..models.layers import ptc_execution
from ..models.lm import (ArchConfig, build_gateway_prefill_step,
                         build_gateway_step, build_serve_step,
                         init_decode_cache, period_plan)
from ..models.ssm import init_ssm_state
from .kv_pages import PageConfig, PagedKVPool
from .scheduler import FINISH_EOS, FINISH_MAX_NEW, Request, Scheduler

__all__ = ["GatewayConfig", "ServingGateway", "build_gateway_hw_plane"]


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Static gateway geometry/policy."""

    slots: int = 4               # concurrent decode streams
    pages: PageConfig = PageConfig()
    max_steps: int = 100_000     # hard stop for the run loop
    # chunked prefill: each prefilling slot ingests up to prefill_chunk
    # prompt tokens per virtual step through the (B, C)-wide prefill step
    # while decode slots ride along producing one token each.  1 = the
    # one-token-per-step path.
    prefill_chunk: int = 1
    # tokens *advanced* per step below the padded width C (a comparison
    # lever of the reference's property tests).  None = C.
    prefill_stride: int | None = None
    kv_block: int | None = None  # prefill kernel KV block (None = whole view)


def build_gateway_hw_plane(gen: torch.Generator | None, cfg: ArchConfig,
                           params, runtime_cfg, n_chips: int, *, slots: int,
                           mode: str = "route", seed: int = 0,
                           recal_enabled: bool = True, device=None):
    """Deploy the model's decode-path PTC layers onto a fresh fleet drawn
    from ``gen`` for gateway serving: one tenant per layer, the ``serve
    --hw-logits`` deployment.  The layers are
    listed by the *solo* serve step, whose scope names the gateway steps
    reproduce."""
    from ..runtime.hw_serve import HwServePlane, record_ptc_layers

    dev = resolve_device(device)
    cache0 = init_decode_cache(cfg, slots, 2, device=dev)
    batch0 = {"token": torch.zeros((slots, 1), dtype=torch.int64,
                                   device=dev), "cache_len": 0}
    layers = record_ptc_layers(build_serve_step(cfg), params, cache0, batch0)
    return HwServePlane(gen, layers, runtime_cfg, n_chips, mode=mode,
                        seed=seed, recal_enabled=recal_enabled, device=dev)


class ServingGateway:
    """The request-level serving loop over one model on one device, with
    an optional hardware-in-the-loop plane (``hw_plane``).

    ``params`` must already lie on ``device`` (``None``: ``cuda``, which
    raises on a host without CUDA).  The reference refuses a plane over a
    jitted or scanned config (its hook is inert under a trace); the port's
    steps run eagerly and walk the periods in a Python loop, so the hook
    sees every call."""

    def __init__(self, cfg: ArchConfig, params, gcfg: GatewayConfig,
                 hw_plane=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gcfg = gcfg
        self.params = params
        self.hw = hw_plane
        self.plan, self.n_periods = period_plan(cfg)
        self.pool = PagedKVPool(gcfg.pages, gcfg.slots)
        self.chunk = max(1, int(gcfg.prefill_chunk))
        self.stride = (self.chunk if gcfg.prefill_stride is None
                       else max(1, min(int(gcfg.prefill_stride), self.chunk)))
        if self.chunk > 1:
            self._step_fn = build_gateway_prefill_step(
                cfg, kv_block=gcfg.kv_block)
        else:
            self._step_fn = build_gateway_step(cfg)

        # tensor pools: one (P·(n_pages+1), page_size, Hkv·Dh) pair per
        # attention sub-layer position — all periods share the slot page
        # table (token t lives at the same page/offset in every layer),
        # each period's pages offset by its stripe.  The +1 page per
        # stripe is the scratch page idle slots and padding scatter into.
        # Mamba positions hold a (P, slots, ...) SSM state instead.
        ps = gcfg.pages.page_size
        self._stripe = gcfg.pages.n_pages + 1
        self._scratch = gcfg.pages.n_pages      # id of the scratch page
        self._kv_dims: dict[str, tuple[int, int]] = {}
        self._pools: dict[str, dict[str, torch.Tensor]] = {}
        self._ssm: dict[str, dict[str, torch.Tensor]] = {}
        for i, sub in enumerate(self.plan):
            name = f"pos{i}"
            if sub.kind == "attn":
                acfg = cfg.attn_cfg(sub.window)
                hk, hd = acfg.n_kv_heads, acfg.head_dim
                self._kv_dims[name] = (hk, hd)
                shape = (self.n_periods * self._stripe, ps, hk * hd)
                self._pools[name] = {
                    kk: torch.zeros(shape, dtype=torch.bfloat16,
                                    device=self.device) for kk in ("k", "v")}
            else:
                one = init_ssm_state(gcfg.slots, cfg.ssm_cfg(), self.device)
                self._ssm[name] = {
                    kk: a.new_zeros((self.n_periods,) + tuple(a.shape))
                    for kk, a in one.items()}

        # counters
        self.step_count = 0
        self.busy_steps = 0
        self.slot_steps = 0          # Σ active slots over busy steps
        self.tokens_out = 0

    # -- paged-pool plumbing -------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A copy (never a view of the host array, which the loop
        mutates) on the gateway's device."""
        return torch.tensor(a, device=self.device)

    def _period_table(self) -> np.ndarray:
        """(P·B, J) page table with per-period stripe offsets."""
        t = self.pool.table
        return np.concatenate(
            [t + p * self._stripe for p in range(self.n_periods)], axis=0)

    def _gather_views(self) -> dict:
        """Assemble every attention position's (P, B, S_max, Hkv, Dh)
        views from the pools: one gather per pool tensor, all periods.
        Mamba positions pass their SSM states."""
        b = self.gcfg.slots
        jps = self.gcfg.pages.max_pages_per_slot * self.gcfg.pages.page_size
        table = self._to_device(self._period_table())
        views = {}
        for name, pools in self._pools.items():
            hk, hd = self._kv_dims[name]
            views[name] = {
                kk: paged_gather(table, pools[kk]).reshape(
                    self.n_periods, b, jps, hk, hd)
                for kk in ("k", "v")}
        views.update(self._ssm)
        return views

    def _period_idx(self, idx: np.ndarray) -> torch.Tensor:
        """(R, 2) targets repeated for every period's stripe: (P·R, 2)."""
        return self._to_device(np.concatenate(
            [idx + np.asarray([[p * self._stripe, 0]], np.int32)
             for p in range(self.n_periods)], axis=0))

    def _scatter(self, new_kv: dict, full_idx: torch.Tensor, scatter) -> None:
        for name, pools in self._pools.items():
            hk, hd = self._kv_dims[name]
            rows = new_kv[name]     # {"k","v"}: (P, B, C, Hkv, Dh)
            for kk in ("k", "v"):
                flat = rows[kk].reshape(-1, hk * hd).to(pools[kk].dtype)
                scatter(full_idx, flat.contiguous(), pools[kk])

    def _scatter_new(self, new_kv: dict, active: Sequence[int]) -> None:
        """Persist each active slot's new KV row at its write position;
        idle slots land on the scratch page.  SSM states are replaced by
        the step's, all slots at once."""
        idx = np.zeros((self.gcfg.slots, 2), np.int32)
        idx[:, 0] = self._scratch
        for slot in active:
            idx[slot] = self.pool.write_pos(slot)
        self._scatter(new_kv, self._period_idx(idx), paged_scatter)
        for name in self._ssm:
            self._ssm[name] = new_kv[name]

    def _scatter_chunk(self, new_kv: dict, act: np.ndarray,
                       take: np.ndarray) -> None:
        """Persist each active slot's first ``take[slot]`` new KV rows at
        its consecutive write positions — chunks crossing page boundaries
        are split host-side by ``PagedKVPool.write_span`` — through ONE
        multi-row scatter per pool tensor.  Padding columns and idle slots
        land on the scratch page; the scatter resolves those duplicate
        targets last-wins, as the reference's sequential grid does."""
        b, c = self.gcfg.slots, self.chunk
        idx = np.zeros((b, c, 2), np.int32)
        idx[:, :, 0] = self._scratch
        for slot in np.flatnonzero(act):
            n = int(take[slot])
            if n:
                idx[slot, :n] = self.pool.write_span(slot, n)
        self._scatter(new_kv, self._period_idx(idx.reshape(b * c, 2)),
                      paged_scatter_rows)

    def _reset_slot(self, slot: int) -> None:
        """Zero an admitted slot's SSM state (pages need no reset: the
        slot writes before it reads, and attention masks by length)."""
        for st in self._ssm.values():
            for a in st.values():
                a[:, slot] = 0

    # -- the loop ------------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> dict:
        """Serve ``requests`` (arrival steps respected — the open-loop
        process) to completion; returns the report dict.

        With ``prefill_chunk`` C > 1 a prefilling slot ingests up to
        min(prefill_stride, remaining) prompt tokens per step while decode
        slots produce one token each (n_valid == 1), all through one
        (B, C)-wide forward."""
        sched = Scheduler(self.pool)
        todo = sorted(requests, key=lambda r: (r.arrival, r.rid))
        next_arrival = 0
        b, chunk, stride = self.gcfg.slots, self.chunk, self.stride
        buf_len = self.gcfg.pages.max_tokens_per_slot
        prompt_buf = np.zeros((b, buf_len), np.int32)
        plen = np.zeros((b,), np.int32)      # prompt length per slot
        slot_pos = np.zeros((b,), np.int32)  # decode position per slot
        last_tok = np.zeros((b,), np.int32)  # last emitted token per slot
        arange_b = np.arange(b)
        arange_c = np.arange(chunk)
        t0 = time.time()
        hook_ctx = (ptc_execution(self.hw.hook) if self.hw is not None
                    else contextlib.nullcontext())
        with hook_ctx:
            while self.step_count < self.gcfg.max_steps:
                step = self.step_count
                while (next_arrival < len(todo)
                       and todo[next_arrival].arrival <= step):
                    sched.submit(todo[next_arrival], step)
                    next_arrival += 1
                for slot, req in sched.admit(step):
                    slot_pos[slot] = 0
                    plen[slot] = req.prompt_len
                    prompt_buf[slot, :req.prompt_len] = req.prompt
                    self._reset_slot(slot)
                if sched.idle:
                    if next_arrival >= len(todo):
                        break                      # drained
                    # open-loop gap: virtual time still passes (drift
                    # walks, probes and repairs run) and the autopilot
                    # sees the trough (zero occupancy)
                    if self.hw is not None:
                        self.hw.observe_load(0.0)
                        self.hw.router.tick()
                    self.step_count += 1
                    continue

                act = np.asarray([r is not None for r in sched.running])
                if self.hw is not None:
                    # occupancy for the autopilot's load forecast: active
                    # slots plus queued requests, over capacity
                    self.hw.observe_load(
                        (int(act.sum()) + len(sched.pending)) / b)
                pre = act & (slot_pos < plen)
                dec = act & ~pre
                # tokens each slot ingests this step (idle slots: none)
                take = np.where(pre, np.minimum(stride, plen - slot_pos),
                                act.astype(np.int32))
                cols = slot_pos[:, None] + arange_c[None, :]     # (B, C)
                valid = arange_c[None, :] < take[:, None]
                tok = np.where(
                    pre[:, None] & valid,
                    prompt_buf[arange_b[:, None],
                               np.minimum(cols, buf_len - 1)],
                    0).astype(np.int32)
                tok[dec, 0] = last_tok[dec]
                batch = {"token": self._to_device(tok),
                         "lens": self._to_device(self.pool.lens)}
                if chunk > 1:
                    batch["n_valid"] = self._to_device(
                        np.maximum(take, 1).astype(np.int32))
                views = self._gather_views()
                step_ctx = (self.hw.step(step,
                                         valid=valid if chunk > 1 else None)
                            if self.hw is not None
                            else contextlib.nullcontext())
                with step_ctx:
                    logits, new_kv = self._step_fn(self.params, views,
                                                   batch)
                if chunk > 1:
                    self._scatter_chunk(new_kv, act, take)
                else:
                    self._scatter_new(new_kv, list(np.flatnonzero(act)))
                preds = torch.argmax(logits, dim=-1).cpu().numpy()
                for slot in np.flatnonzero(act):
                    req = sched.running[slot]
                    n = int(take[slot])
                    self.pool.advance(slot, n)
                    pos = slot_pos[slot] = slot_pos[slot] + n
                    if pos < plen[slot]:
                        continue                             # still prefilling
                    nxt = int(preds[slot])
                    req.out_tokens.append(nxt)
                    last_tok[slot] = nxt
                    self.tokens_out += 1
                    if req.first_token_step < 0:
                        req.first_token_step = step
                    if req.eos_id is not None and nxt == req.eos_id:
                        sched.finish(slot, step, FINISH_EOS)
                    elif len(req.out_tokens) >= req.max_new:
                        sched.finish(slot, step, FINISH_MAX_NEW)
                self.busy_steps += 1
                self.slot_steps += int(act.sum())
                self.step_count += 1
        if self.device.type == "cuda":
            # the wall covers the card's work, as serve.run's does
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        if not sched.idle:
            raise RuntimeError(
                f"gateway hit max_steps={self.gcfg.max_steps} with "
                f"{len(sched.pending)} queued / {sched.n_active} running "
                f"requests unfinished")
        return self._report(sched, wall)

    # -- reporting -----------------------------------------------------------

    def _report(self, sched: Scheduler, wall: float) -> dict:
        reqs = sorted(sched.finished, key=lambda r: r.rid)
        lats = np.asarray([r.latency() for r in reqs], np.float64)
        waits = np.asarray([r.admitted_step - r.arrival for r in reqs],
                           np.float64)
        ttfts = np.asarray([r.ttft() for r in reqs], np.float64)

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else 0.0

        rep = dict(
            requests=[dict(rid=r.rid, prompt_len=r.prompt_len,
                           max_new=r.max_new, arrival=r.arrival,
                           admitted=r.admitted_step,
                           first_token=r.first_token_step,
                           finished=r.finished_step,
                           finish_reason=r.finish_reason,
                           n_out=len(r.out_tokens),
                           tokens=list(map(int, r.out_tokens)))
                      for r in reqs],
            steps=self.step_count, busy_steps=self.busy_steps,
            occupancy=(self.slot_steps / self.busy_steps
                       if self.busy_steps else 0.0),
            tokens_out=self.tokens_out, wall_s=wall,
            tokens_per_s=self.tokens_out / wall if wall > 0 else 0.0,
            latency_steps=dict(p50=pct(lats, 50), p99=pct(lats, 99),
                               mean=float(lats.mean()) if len(lats) else 0.0),
            ttft_steps=dict(p50=pct(ttfts, 50), p99=pct(ttfts, 99),
                            mean=float(ttfts.mean()) if len(ttfts) else 0.0),
            admission_wait_steps=dict(p50=pct(waits, 50),
                                      p99=pct(waits, 99)),
            schedule_trace=list(sched.trace),
        )
        if self.hw is not None:
            rep["fleet"] = self.hw.report()
        return rep

    def close(self) -> None:
        if self.hw is not None:
            self.hw.close()
