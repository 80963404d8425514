"""Batched serving driver: greedy decode against a dense KV cache.

Counterpart of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smoke:qwen3-4b \\
        --device cpu --batch 4 --prompt-len 16 --gen 32

Without ``--device`` it runs on ``cuda`` (and refuses a host without
CUDA).  ``--gateway`` hands the run to the continuous-batching gateway
(:mod:`repro_torch.serving.gateway`).

``--fleet N`` dispatches the decode loop through the closed-loop photonic
runtime (:mod:`repro_torch.runtime`): N virtual chips with their own
device realizations, health probes out of band, and (``--drift``) phase
drift until the router schedules repairs around live traffic.  With
``--fleet-tenants T`` every chip carries T mapped layers of
``--fleet-dim`` and step ``i`` serves tenant ``i mod T``; the LM itself
stays digital in this synthetic-traffic mode.

``--hw-logits`` goes the rest of the way: the served model's own PTC
layers deploy onto the fleet (one tenant per layer,
:class:`~repro_torch.runtime.hw_serve.HwServePlane`), each decode step
routes the whole forward pass to one chip and every PTC product runs
through that chip's realized (drifted) transfer, so the logits are what
the photonic hardware computes.  ``--hw-shadow`` deploys the same way but
serves the deployment-time readback transfer digitally: at σ_drift = 0 it
is token-identical to ``--hw-logits``.  ``--fleet-driver subprocess|socket``
puts every chip behind a device server child (``repro_torch.hw.server``
on the same ``--device``) over pipes or TCP; the logits are bit-identical
to the in-process twin's.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import parse_arch
from ..data.synthetic import lm_batch
from ..device import resolve_device
from ..models.lm import (ArchConfig, build_serve_step, init_decode_cache,
                         init_model)
from ..serving.gateway import add_gateway_args
from .steps import greedy_decode

__all__ = ["run", "main", "add_autopilot_args"]


def add_autopilot_args(ap: argparse.ArgumentParser) -> None:
    """Fleet scheduling and routing knobs shared by ``launch.serve`` and
    ``serving.gateway`` (both build their fleet policy through
    :func:`_hw_runtime_config`)."""
    ap.add_argument("--autopilot", action="store_true",
                    help="forecast-driven fleet maintenance: proactive "
                         "recals before predicted alarm crossings, "
                         "degradation-rate repair priority, scheduled "
                         "into the gateway's occupancy troughs")
    ap.add_argument("--ap-horizon", type=int, default=40,
                    help="autopilot: proactive window (ticks)")
    ap.add_argument("--ap-trough", type=float, default=0.5,
                    help="autopilot: load forecast at/below this "
                         "fraction of capacity counts as a trough")
    ap.add_argument("--ap-budget", type=float, default=None,
                    help="autopilot: recal PTC-call envelope per window "
                         "(default unlimited)")
    ap.add_argument("--ap-window", type=int, default=200,
                    help="autopilot: budget window (ticks)")
    ap.add_argument("--fleet-policy", default=None,
                    choices=["drift_aware", "accuracy_aware",
                             "least_served"],
                    help="dispatch ranking policy (default: the demo "
                         "config's drift_aware)")


def _apply_fleet_policy(args, cfg):
    """Fold the shared CLI scheduling knobs into a RuntimeConfig."""
    policy = getattr(args, "fleet_policy", None)
    if policy:
        cfg = dataclasses.replace(cfg, router_policy=policy)
    if getattr(args, "autopilot", False):
        from ..runtime.autopilot import AutopilotConfig
        budget = getattr(args, "ap_budget", None)
        cfg = dataclasses.replace(cfg, autopilot=AutopilotConfig(
            horizon=getattr(args, "ap_horizon", 40),
            trough_load=getattr(args, "ap_trough", 0.5),
            budget_calls=float("inf") if budget is None else budget,
            budget_window=getattr(args, "ap_window", 200)))
    return cfg


def _build_fleet(args, dev: torch.device):
    """The synthetic-traffic fleet: ``--fleet-tenants`` weights of
    ``--fleet-dim`` on ``--fleet`` chips (weights and chips drawn from one
    CPU generator seeded by ``--seed`` + 17)."""
    from ..runtime.demo import default_runtime_config, _make_weights
    from ..runtime.fleet import make_fleet, make_router

    sigma = args.drift_sigma if args.drift else 0.0
    cfg = default_runtime_config(k=args.fleet_k, sigma_drift=sigma,
                                 probe_every=args.probe_every,
                                 driver_kind=args.fleet_driver)
    cfg = _apply_fleet_policy(args, cfg)
    gen = torch.Generator("cpu").manual_seed(args.seed + 17)
    dim = args.fleet_dim
    tenants = max(1, args.fleet_tenants)
    weights = [w.to(dev) for w in _make_weights(gen, dim, tenants)]
    chips = make_fleet(gen, args.fleet,
                       weights if tenants > 1 else weights[0], cfg,
                       device=dev)
    return make_router(chips, cfg, seed=args.seed), dim, tenants


def _hw_runtime_config(args):
    """Fleet policy for the hw-logits plane: ``args.runtime_cfg`` when given
    (the accuracy benchmark tunes thresholds), else the demo defaults at
    the CLI's drift and probe cadence with ``--autopilot`` /
    ``--fleet-policy`` folded in; ``--deploy-zo`` adds PM's ZO stage."""
    from ..runtime.demo import default_runtime_config

    cfg = getattr(args, "runtime_cfg", None)
    if cfg is None:
        sigma = args.drift_sigma if args.drift else 0.0
        cfg = default_runtime_config(k=args.fleet_k, sigma_drift=sigma,
                                     probe_every=args.probe_every,
                                     driver_kind=args.fleet_driver)
        cfg = _apply_fleet_policy(args, cfg)
    if getattr(args, "deploy_zo", False):
        cfg = dataclasses.replace(cfg, deploy_zo=True)
    return cfg


def _build_hw_plane(args, cfg, params, serve_fn, extras, mode: str,
                    dev: torch.device):
    """List the model's decode-path PTC layers (one dry digital step) and
    deploy them, one tenant per layer, onto a fresh fleet drawn from a CPU
    generator seeded by ``--seed`` + 17."""
    from ..runtime.hw_serve import HwServePlane, record_ptc_layers

    cache0 = init_decode_cache(cfg, args.batch, 2, device=dev)
    batch0 = {"token": torch.zeros((args.batch, 1), dtype=torch.int64,
                                   device=dev),
              "cache_len": 0, **extras}
    layers = record_ptc_layers(serve_fn, params, cache0, batch0)
    return HwServePlane(torch.Generator("cpu").manual_seed(args.seed + 17),
                        layers, _hw_runtime_config(args), args.fleet,
                        mode=mode, seed=args.seed,
                        recal_enabled=not getattr(args, "no_recal", False),
                        device=dev)


def _hw_mode(args) -> str | None:
    """``"route"``, ``"shadow"`` or None; the two hw flags are exclusive
    and need ``--fleet``."""
    hw_mode = "route" if getattr(args, "hw_logits", False) else None
    if getattr(args, "hw_shadow", False):
        if hw_mode is not None:
            raise ValueError("--hw-logits and --hw-shadow are exclusive")
        hw_mode = "shadow"
    if hw_mode is not None and getattr(args, "fleet", 0) <= 0:
        raise ValueError("--hw-logits/--hw-shadow need --fleet N chips")
    return hw_mode


def run(args) -> dict:
    """Serve ``args.gen`` tokens to a batch of ``args.batch`` prompts
    through greedy decode on ``args.device`` (None: ``cuda``), optionally
    through the fleet runtime; returns the generated tokens ``gen`` (B,
    gen), the per-step argmax ``preds`` (B, prompt_len + gen − 1),
    ``wall_s`` (the card synchronized at its end), ``tokens_per_s`` and the
    router's ``report`` (None without ``--fleet``; with ``--hw-logits`` /
    ``--hw-shadow`` it has an ``hw`` section); with ``args.trace_logits``
    also ``logits`` (steps, B, V).

    Test hooks as the reference's: ``args.params_override`` serves given
    params (on the device) instead of a seeded random init;
    ``args.prompt_tokens`` replaces the ``lm_batch`` prompts;
    ``args.runtime_cfg`` the fleet policy.  vlm and encdec archs get
    the reference's stub inputs, ``img`` (B, n_img, d) and ``enc_out`` (B,
    prompt_len, d) of 0.1.  With ``args.gateway`` the whole run is the
    gateway's (:func:`repro_torch.serving.gateway.run`) and so is the
    report."""
    if getattr(args, "gateway", False):
        from ..serving.gateway import run as run_gateway
        return run_gateway(args)
    cfg = (args.arch if isinstance(args.arch, ArchConfig)
           else parse_arch(args.arch))
    hw_mode = _hw_mode(args)
    if hw_mode is not None and cfg.n_experts > 0:
        # the reference runs expert FFNs under jax.vmap, where its layer
        # hook is inert: serving them would leave the FFN digital while
        # claiming hardware logits
        raise ValueError(
            f"--hw-logits/--hw-shadow do not support MoE archs yet "
            f"({cfg.name}: {cfg.n_experts} experts run under vmap, "
            f"unreachable by the PTC execution hook)")
    dev = resolve_device(getattr(args, "device", None))
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

    on_step = router = plane = report = None
    if hw_mode is not None:
        plane = _build_hw_plane(args, cfg, params, serve, extras, hw_mode,
                                dev)
    elif getattr(args, "fleet", 0) > 0:
        router, fleet_dim, tenants = _build_fleet(args, dev)
        gx = torch.Generator("cpu").manual_seed(args.seed + 23)

        def on_step(i):
            # every serve-path step (prefill included) runs on one routed
            # (drifted) board, on the step's (chip, tenant) slot
            x = torch.randn((args.batch, fleet_dim), generator=gx).to(dev)
            router.serve(x, tenant=i % tenants)
            router.tick()

    preds: list = []
    logits_trace = [] if getattr(args, "trace_logits", False) else None
    try:
        t0 = time.perf_counter()
        gen, _ = greedy_decode(serve, params, cache, prompt, args.gen,
                               extras=extras, on_step=on_step,
                               layer_exec=plane, preds_out=preds,
                               logits_out=logits_trace)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if plane is not None:
            report = plane.report()
        elif router is not None:
            report = router.report()
    finally:
        if plane is not None:
            plane.close()
        if router is not None:
            router.close()
    out = dict(gen=gen, wall_s=dt, tokens_per_s=gen.size / dt, report=report,
               preds=np.stack(preds, axis=1) if preds else
               np.zeros((args.batch, 0), np.int32))
    if logits_trace is not None:
        out["logits"] = np.stack(logits_trace, axis=0)
    return out


def _print_fleet_report(rep: dict, n_chips: int) -> None:
    """The fleet report's printout (chips, tenants, the hw section)."""
    alarms = sum(c["alarms"] for c in rep["chips"])
    recals = sum(c["recals"] for c in rep["chips"])
    n_tenants = len(rep["chips"][0]["tenants"])
    print(f"fleet: {n_chips} chips x {n_tenants} tenant(s), "
          f"{rep['ticks']} ticks, {rep['dropped']} dropped, {alarms} alarms, "
          f"{recals} recals")
    hw = rep.get("hw")
    if hw is not None:
        print(f"hw-logits [{hw['mode']}]: {len(hw['layers'])} PTC layers as "
              f"tenants, {hw['frames']} driver frames over {hw['steps']} "
              f"steps ({hw['frames_per_step']:.1f} frames/step), "
              f"{hw['hw_calls']} hw matmuls, {hw['shadow_calls']} shadow "
              f"matmuls, {hw['dropped_passes']} dropped passes")
    for c in rep["chips"]:
        print(f"  chip {c['chip']}: {c['status']:<13} served={c['served']:4d} "
              f"d̂={c['distance']:.4f} alarms={c['alarms']} "
              f"recals={c['recals']}")
        if n_tenants > 1:
            for t in c["tenants"]:
                print(f"    tenant {t['tenant']} blocks{t['block_range']}: "
                      f"served={t['served']:4d} d̂={t['distance']:.4f} "
                      f"alarms={t['alarms']} recals={t['recals']}")


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
    ap.add_argument("--fleet", type=int, default=0,
                    help="route decode steps through N virtual chips")
    ap.add_argument("--drift", action="store_true",
                    help="enable thermal phase drift on the fleet")
    ap.add_argument("--drift-sigma", type=float, default=0.015)
    ap.add_argument("--probe-every", type=int, default=10)
    ap.add_argument("--fleet-k", type=int, default=6)
    ap.add_argument("--fleet-dim", type=int, default=18)
    ap.add_argument("--fleet-tenants", type=int, default=1,
                    help="mapped layers time-sharing each chip; decode "
                         "step i routes to tenant i %% T (synthetic-"
                         "traffic mode; --hw-logits derives tenants from "
                         "the model instead)")
    ap.add_argument("--fleet-driver", default="twin",
                    choices=["twin", "subprocess", "socket"],
                    help="photonic device transport behind the fleet "
                         "(subprocess / socket: a device server child per "
                         "chip)")
    ap.add_argument("--hw-logits", action="store_true",
                    help="deploy the model's PTC layers onto the fleet "
                         "(one tenant per layer) and run every decode-path "
                         "product through the routed chip's realized "
                         "transfer")
    ap.add_argument("--hw-shadow", action="store_true",
                    help="deploy like --hw-logits but serve the "
                         "deployment-time readback transfer digitally "
                         "(the sigma=0 token-identity reference path)")
    ap.add_argument("--deploy-zo", action="store_true",
                    help="run PM's alternate-ZCD stage at deployment")
    ap.add_argument("--no-recal", action="store_true",
                    help="open loop: alarms fire, nothing recovers")
    add_autopilot_args(ap)
    ap.add_argument("--gateway", action="store_true",
                    help="serve an open-loop request stream through the "
                         "continuous-batching gateway instead of one "
                         "lockstep batch; the gateway flags configure it")
    add_gateway_args(ap)
    args = ap.parse_args(argv)

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
    if out["report"] is not None:
        _print_fleet_report(out["report"], args.fleet)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
