"""Step builders shared by the train and serve drivers.

Counterpart of ``repro/launch/steps.py``: the training state and update
step (the sampled in-situ gradients of ``lm.build_train_step``, an
optional schedule, AdamW on the trainable leaves only), the prefill step
and the solo serve loop.  The port's optimizer works on lists of
tensors: the update step flattens the parameter, gradient and
trainability trees in one order (sorted dict keys, the order ``jax.tree``
walks them).  The layer-execution plane of ``greedy_decode``
(``layer_exec``: hardware-in-the-loop serving through a chip fleet)
waits for the closed-loop slice; passing one is an error.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from ..core.sparsity import SparsityConfig
from ..models.lm import (ArchConfig, build_train_step, forward, init_model,
                         model_trainable_mask)
from ..optim.optimizers import (AdamWConfig, OptState, SGDConfig,
                                apply_updates, init_opt_state)

__all__ = ["init_train_state", "build_update_step", "build_prefill_step",
           "greedy_decode", "flatten", "unflatten"]


def flatten(tree: dict) -> list:
    """A nested dict's leaves, keys in sorted order at every level."""
    out = []
    for _, v in sorted(tree.items()):
        out.extend(flatten(v) if isinstance(v, dict) else [v])
    return out


def unflatten(like: dict, leaves: list) -> dict:
    """The inverse of :func:`flatten` onto ``like``'s structure."""
    it = iter(leaves)

    def build(node):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in sorted(node.items())}

    return build(like)


def init_train_state(gen: torch.Generator, cfg: ArchConfig
                     ) -> tuple[dict, OptState]:
    """Seeded parameters on the generator's device and their AdamW state
    (moments and fp32 master copies of the trainable leaves only, in
    :func:`flatten`'s order)."""
    params = init_model(gen, cfg)
    opt = init_opt_state(flatten(params),
                         flatten(model_trainable_mask(params)))
    return params, opt


def build_update_step(cfg: ArchConfig, ocfg: AdamWConfig | SGDConfig,
                      sparsity: SparsityConfig | None = None,
                      lr_schedule: Callable | None = None):
    """Returns ``update_step(params, opt_state, batch, gen) -> (params,
    opt_state, loss, gnorm)``: the sampled in-situ gradients (masks drawn
    from ``gen``), the schedule's multiplier at ``opt_state.step``, and
    one optimizer step on the trainable leaves (Σ and the electronics);
    the frozen bases pass through."""
    ts = build_train_step(cfg, sparsity)

    def update_step(params, opt_state, batch, gen=None):
        loss, grads = ts(params, batch, gen)
        scale = lr_schedule(opt_state.step) if lr_schedule else 1.0
        leaves, opt_state, gnorm = apply_updates(
            flatten(params), flatten(grads), opt_state, ocfg, lr_scale=scale,
            trainable=flatten(model_trainable_mask(params)))
        return unflatten(params, leaves), opt_state, loss, gnorm

    return update_step


def build_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch) -> (B, vocab)`` last-position logits
    of a full-sequence forward (inference prefill)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = forward(params, cfg, batch)
        return logits[:, -1]

    return prefill_step


def _first_tensor(tree) -> torch.Tensor:
    if isinstance(tree, dict):
        return _first_tensor(next(iter(tree.values())))
    return tree


def greedy_decode(serve_step, params, cache, prompt, gen: int,
                  extras: dict | None = None,
                  on_step: Callable[[int], None] | None = None,
                  layer_exec=None,
                  preds_out: list | None = None,
                  logits_out: list | None = None,
                  eos_id: int | None = None):
    """Teacher-forced prefill through the decode cache, then greedy
    generation of ``gen`` tokens.

    ``serve_step`` is a :func:`repro_torch.models.lm.build_serve_step`
    product; ``prompt`` is (B, prompt_len) integers (numpy or a tensor);
    the tokens go to the cache's device.  The prompt streams token by
    token, so the cache fills along the code path generation uses.
    ``on_step(i)`` runs after every step, prefill positions included
    (``prompt_len + gen − 1`` calls in all).  ``extras`` joins every
    step's batch: vlm's ``img``, encdec's ``enc_out`` (tensors on the
    cache's device).

    ``layer_exec`` plugs a layer-execution plane into the loop
    (:class:`repro_torch.runtime.hw_serve.HwServePlane`): its ``hook`` is
    installed as the PTC executor for the whole decode and every step runs
    inside ``layer_exec.step(i)``, so the decode path's PTC products run on
    routed photonic chips, with drift and repairs between steps.  The
    port's steps walk their periods in a Python loop, so the hook sees
    every call.

    ``preds_out`` / ``logits_out`` collect each step's argmax (B,) and
    logits (B, V) as numpy, prefill included.  ``eos_id`` ends a row once
    it emits the stop token (generation region only): its later columns
    are ``eos_id`` and are fed back frozen, and the loop exits once every
    row has finished.

    Returns ``(generated, cache)`` with ``generated`` (B, gen) int32 numpy.
    """
    from ..models.layers import ptc_execution

    extras = extras or {}
    dev = _first_tensor(cache).device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    b, prompt_len = prompt.shape
    max_len = prompt_len + gen
    tok = prompt[:, :1].to(dev)
    out_tokens = []
    finished = np.zeros((b,), bool)
    hook_ctx = (ptc_execution(layer_exec.hook) if layer_exec is not None
                else contextlib.nullcontext())
    with hook_ctx:
        for i in range(max_len - 1):
            batch = {"token": tok, "cache_len": i, **extras}
            step_ctx = (layer_exec.step(i) if layer_exec is not None
                        else contextlib.nullcontext())
            with step_ctx:
                logits, cache = serve_step(params, cache, batch)
            nxt = torch.argmax(logits, dim=-1)
            emitted = nxt.cpu().numpy().astype(np.int32)
            if preds_out is not None:
                preds_out.append(emitted)
            if logits_out is not None:
                logits_out.append(logits.float().cpu().numpy())
            if i + 1 < prompt_len:
                tok = prompt[:, i + 1: i + 2].to(dev)   # teacher-forced
            else:
                if eos_id is not None:
                    emitted = np.where(finished, np.int32(eos_id), emitted)
                    finished |= emitted == eos_id
                tok = torch.as_tensor(emitted, dtype=torch.int64,
                                      device=dev)[:, None]
                out_tokens.append(emitted)
            if on_step is not None:
                on_step(i)
            if eos_id is not None and finished.all():
                break
    if not out_tokens:        # gen=0: prefill-only run
        return np.zeros((b, 0), np.int32), cache
    gen_out = np.stack(out_tokens, axis=1)
    if eos_id is not None and gen_out.shape[1] < gen:
        pad = np.full((b, gen - gen_out.shape[1]), eos_id, np.int32)
        gen_out = np.concatenate([gen_out, pad], axis=1)
    return gen_out, cache
