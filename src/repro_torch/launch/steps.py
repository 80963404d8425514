"""The solo serve loop shared by the serving drivers.

Counterpart of ``greedy_decode`` in ``repro/launch/steps.py``.  The
training-step builders of that module wait for the training slice of the
port, and the layer-execution plane (``layer_exec``: hardware-in-the-loop
serving through a chip fleet) for the closed-loop slice; passing one is
an error.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["greedy_decode"]


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
    (``prompt_len + gen − 1`` calls in all).

    ``preds_out`` / ``logits_out`` collect each step's argmax (B,) and
    logits (B, V) as numpy, prefill included.  ``eos_id`` ends a row once
    it emits the stop token (generation region only): its later columns
    are ``eos_id`` and are fed back frozen, and the loop exits once every
    row has finished.

    Returns ``(generated, cache)`` with ``generated`` (B, gen) int32 numpy.
    """
    if layer_exec is not None:
        raise ValueError(
            "greedy_decode: a layer-execution plane (hardware-in-the-loop "
            "serving) is not ported yet (ROADMAP.md, queue 1, 'HW-logits "
            "gateway serving')")
    if extras:
        raise ValueError(f"greedy_decode: extras {sorted(extras)} feed the "
                         f"vlm / encdec families, which are not ported yet")
    dev = _first_tensor(cache).device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int64)
    b, prompt_len = prompt.shape
    max_len = prompt_len + gen
    tok = prompt[:, :1].to(dev)
    out_tokens = []
    finished = np.zeros((b,), bool)
    for i in range(max_len - 1):
        logits, cache = serve_step(params, cache,
                                   {"token": tok, "cache_len": i})
        nxt = torch.argmax(logits, dim=-1)
        emitted = nxt.cpu().numpy().astype(np.int32)
        if preds_out is not None:
            preds_out.append(emitted)
        if logits_out is not None:
            logits_out.append(logits.float().cpu().numpy())
        if i + 1 < prompt_len:
            tok = prompt[:, i + 1: i + 2].to(dev)       # teacher-forced
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
