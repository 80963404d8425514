"""Batched serving driver: greedy decode against a dense KV cache.

Counterpart of ``repro/launch/serve.py`` on the digital path::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smoke:qwen3-4b \\
        --device cpu --batch 4 --prompt-len 16 --gen 32

Without ``--device`` it runs on ``cuda`` (and refuses a host without
CUDA).  ``--gateway`` hands the run to the continuous-batching gateway
(:mod:`repro_torch.serving.gateway`).  The reference's fleet,
hardware-in-the-loop, drift and autopilot flags belong to the closed-loop
slice of the port: passing one is an error (exit 2).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import parse_arch
from ..data.synthetic import lm_batch
from ..device import resolve_device
from ..models.lm import (ArchConfig, build_serve_step, init_decode_cache,
                         init_model)
from ..serving.gateway import HW_FLAGS, add_gateway_args
from .steps import greedy_decode

__all__ = ["run", "main"]

# the reference CLI's fleet / hardware-in-the-loop / autopilot flags (its
# gateway's HW_FLAGS, the fleet geometry and add_autopilot_args)
REFUSED_FLAGS = HW_FLAGS + ("--fleet-dim", "--fleet-tenants", "--autopilot",
                            "--ap-horizon", "--ap-trough", "--ap-budget",
                            "--ap-window", "--fleet-policy")


def _refused(args) -> list[str]:
    """The refused flags ``args`` sets (a ``--fleet`` of 0 is the
    reference's default, not a request)."""
    given = []
    for flag in REFUSED_FLAGS:
        val = getattr(args, flag[2:].replace("-", "_"), None)
        if val is not None and val is not False and not (
                flag == "--fleet" and val == 0):
            given.append(flag)
    return given


def run(args) -> dict:
    """Serve ``args.gen`` tokens to a batch of ``args.batch`` prompts
    through greedy decode on ``args.device`` (None: ``cuda``); returns the
    generated tokens ``gen`` (B, gen), the per-step argmax ``preds`` (B,
    prompt_len + gen − 1), ``wall_s`` (the card synchronized at its end)
    and ``tokens_per_s``; with ``args.trace_logits`` also ``logits``
    (steps, B, V).

    Test hooks as the reference's: ``args.params_override`` serves given
    params (on the device) instead of a seeded random init;
    ``args.prompt_tokens`` replaces the ``lm_batch`` prompts.  vlm and
    encdec archs get the reference's stub inputs, ``img`` (B, n_img, d)
    and ``enc_out`` (B, prompt_len, d) of 0.1.  With
    ``args.gateway`` the whole run is the gateway's
    (:func:`repro_torch.serving.gateway.run`) and so is the report."""
    if getattr(args, "gateway", False):
        from ..serving.gateway import run as run_gateway
        return run_gateway(args)
    refused = _refused(args)
    if refused:
        raise ValueError(f"{', '.join(refused)}: fleet and hardware-in-the-"
                         f"loop serving are not ported yet (ROADMAP.md, "
                         f"queue 1, 'HW-logits gateway serving')")
    dev = resolve_device(getattr(args, "device", None))
    cfg = (args.arch if isinstance(args.arch, ArchConfig)
           else parse_arch(args.arch))
    params = getattr(args, "params_override", None)
    if params is None:
        params = init_model(torch.Generator(dev).manual_seed(args.seed), cfg)

    prompt = getattr(args, "prompt_tokens", None)
    if prompt is None:
        prompt = lm_batch(args.seed, 0, args.batch, args.prompt_len,
                          cfg.vocab)["tokens"]
    prompt = np.asarray(prompt, np.int32)
    cache = init_decode_cache(cfg, args.batch, prompt.shape[1] + args.gen,
                              device=dev)
    serve = build_serve_step(cfg)
    # the stubbed modality inputs, as the reference's driver makes them
    extras = {}
    if cfg.family == "vlm":
        extras["img"] = 0.1 * torch.ones(
            (args.batch, cfg.n_img_tokens, cfg.d_model), device=dev)
    if cfg.family == "encdec":
        extras["enc_out"] = 0.1 * torch.ones(
            (args.batch, prompt.shape[1], cfg.d_model), device=dev)

    preds: list = []
    logits_trace = [] if getattr(args, "trace_logits", False) else None
    t0 = time.perf_counter()
    gen, _ = greedy_decode(serve, params, cache, prompt, args.gen,
                           extras=extras, preds_out=preds,
                           logits_out=logits_trace)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    out = dict(gen=gen, wall_s=dt, tokens_per_s=gen.size / dt, report=None,
               preds=np.stack(preds, axis=1) if preds else
               np.zeros((args.batch, 0), np.int32))
    if logits_trace is not None:
        out["logits"] = np.stack(logits_trace, axis=0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="batched greedy-decode serving (PyTorch port)")
    ap.add_argument("--arch", required=True,
                    help="arch id, or smoke:<id> for the reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve an open-loop request stream through the "
                         "continuous-batching gateway instead of one "
                         "lockstep batch; the gateway flags configure it")
    add_gateway_args(ap)
    for flag in REFUSED_FLAGS:            # accepted only to be refused
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    refused = _refused(args)
    if refused:
        ap.error(f"{', '.join(refused)}: fleet and hardware-in-the-loop "
                 f"serving are not ported yet (ROADMAP.md, queue 1, "
                 f"'HW-logits gateway serving')")

    if args.gateway:
        rep = run(args)
        c = rep["config"]
        lat = rep["latency_steps"]
        print(f"gateway [{c['hw_mode']}, {c['device']}] {c['arch']}: "
              f"{c['n_requests']} requests, {rep['tokens_out']} tokens in "
              f"{rep['wall_s']:.1f}s ({rep['tokens_per_s']:.1f} tok/s), "
              f"latency p50={lat['p50']:.0f} p99={lat['p99']:.0f} steps")
        return 0

    out = run(args)
    gen = out["gen"]
    print(f"generated {gen.shape} tokens in {out['wall_s']:.1f}s "
          f"({out['tokens_per_s']:.1f} tok/s)")
    print("sample:", gen[0][:24])
    print("preds:", out["preds"].shape)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
