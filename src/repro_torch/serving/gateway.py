"""Serving-gateway CLI: continuous batching over an open-loop workload.

Counterpart of ``repro/serving/gateway.py`` (digital serving)::

    PYTHONPATH=src python -m repro_torch.serving.gateway \\
        --arch smoke:qwen3-4b --device cpu --prefill-chunk 4

Without ``--device`` it runs on ``cuda`` (and refuses a host without
CUDA).  Add ``--fleet N --hw-logits`` to serve every request's PTC
products through routed photonic chips: one coalesced driver frame per
layer group per step carries ALL in-flight requests' activations.
``launch.serve --gateway`` forwards here, so both entry points share this
driver.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import parse_arch
from ..device import resolve_device
from ..models.lm import ArchConfig, init_model
from .engine import GatewayConfig, ServingGateway, build_gateway_hw_plane
from .kv_pages import PageConfig
from .scheduler import poisson_workload

__all__ = ["run", "main", "add_gateway_args"]

def add_gateway_args(ap: argparse.ArgumentParser) -> None:
    """Gateway knobs (the reference's, with their ``--gw-`` aliases)."""
    ap.add_argument("--slots", "--gw-slots", dest="slots", type=int,
                    default=4, help="concurrent decode streams")
    ap.add_argument("--requests", "--gw-requests", dest="requests",
                    type=int, default=8, help="workload size")
    ap.add_argument("--rate", "--gw-rate", dest="rate", type=float,
                    default=0.5, help="Poisson arrival rate (req/step)")
    ap.add_argument("--page-size", "--gw-page-size", dest="page_size",
                    type=int, default=8, help="tokens per KV page")
    ap.add_argument("--pages", "--gw-pages", dest="pages", type=int,
                    default=64, help="physical pages in the shared pool")
    ap.add_argument("--max-pages-per-slot", "--gw-max-pages-per-slot",
                    dest="max_pages_per_slot", type=int, default=8,
                    help="page-table length per slot")
    ap.add_argument("--max-new", "--gw-max-new", dest="max_new", type=int,
                    nargs=2, default=(4, 12), metavar=("LO", "HI"),
                    help="uniform decode-budget range per request")
    ap.add_argument("--gw-prompt-len", dest="prompt_len_range", type=int,
                    nargs=2, default=(4, 12), metavar=("LO", "HI"),
                    help="uniform prompt-length range per request")
    ap.add_argument("--eos-id", "--gw-eos-id", dest="eos_id", type=int,
                    default=None, help="stop token (early termination)")
    ap.add_argument("--prefill-chunk", "--gw-prefill-chunk",
                    dest="prefill_chunk", type=int, default=1,
                    help="prompt tokens ingested per prefilling slot per "
                         "step (1 = the one-token path)")


def run(args) -> dict:
    """Build the gateway for ``args`` and drive the workload to
    completion; returns the engine report plus the resolved config (and,
    with ``--hw-logits`` / ``--hw-shadow``, the fleet report under
    ``"fleet"``).

    ``args.device`` (None: ``cuda``) places the model, the pools and the
    fleet.  Test hooks as the reference's: ``args.params_override`` serves
    given params (already on the device) instead of a seeded random init;
    ``args.requests_override`` replaces the Poisson workload;
    ``args.runtime_cfg`` the fleet policy."""
    from ..launch.serve import _hw_mode, _hw_runtime_config

    dev = resolve_device(getattr(args, "device", None))
    cfg = (args.arch if isinstance(args.arch, ArchConfig)
           else parse_arch(args.arch))
    hw_mode = _hw_mode(args)
    params = getattr(args, "params_override", None)
    if params is None:
        params = init_model(torch.Generator(dev).manual_seed(args.seed), cfg)

    reqs = getattr(args, "requests_override", None)
    if reqs is None:
        pl = getattr(args, "prompt_len_range", (4, 12))
        reqs = poisson_workload(args.seed, args.requests, args.rate,
                                cfg.vocab, prompt_len=tuple(pl),
                                max_new=tuple(args.max_new),
                                eos_id=args.eos_id)

    gcfg = GatewayConfig(
        slots=args.slots,
        pages=PageConfig(page_size=args.page_size, n_pages=args.pages,
                         max_pages_per_slot=args.max_pages_per_slot),
        prefill_chunk=getattr(args, "prefill_chunk", 1) or 1,
        prefill_stride=getattr(args, "prefill_stride", None),
        kv_block=getattr(args, "kv_block", None))
    plane = None
    if hw_mode is not None:
        plane = build_gateway_hw_plane(
            torch.Generator("cpu").manual_seed(args.seed + 17), cfg, params,
            _hw_runtime_config(args), args.fleet, slots=args.slots,
            mode=hw_mode, seed=args.seed,
            recal_enabled=not getattr(args, "no_recal", False), device=dev)
    gw = ServingGateway(cfg, params, gcfg, hw_plane=plane, device=dev)
    try:
        rep = gw.run(reqs)
    finally:
        gw.close()
    rep["config"] = dict(arch=cfg.name, slots=args.slots,
                         page_size=args.page_size, pages=args.pages,
                         prefill_chunk=gcfg.prefill_chunk,
                         hw_mode=hw_mode or "digital", n_requests=len(reqs),
                         device=str(dev))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="continuous-batching LM gateway (PyTorch port)")
    ap.add_argument("--arch", required=True,
                    help="arch id, or smoke:<id> for the reduced config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    add_gateway_args(ap)
    ap.add_argument("--fleet", type=int, default=0,
                    help="photonic chips backing --hw-logits/--hw-shadow")
    ap.add_argument("--drift", action="store_true")
    ap.add_argument("--drift-sigma", type=float, default=0.015)
    ap.add_argument("--probe-every", type=int, default=10)
    ap.add_argument("--fleet-k", type=int, default=6)
    ap.add_argument("--fleet-driver", default="twin",
                    choices=["twin", "subprocess", "socket"],
                    help="photonic device transport (subprocess / "
                         "socket: a device server child per chip)")
    ap.add_argument("--hw-logits", action="store_true",
                    help="serve every request's PTC products through the "
                         "routed chips (coalesced frames)")
    ap.add_argument("--hw-shadow", action="store_true")
    ap.add_argument("--deploy-zo", action="store_true")
    ap.add_argument("--no-recal", action="store_true")
    from ..launch.serve import add_autopilot_args
    add_autopilot_args(ap)
    args = ap.parse_args(argv)

    rep = run(args)
    c = rep["config"]
    lat, wait = rep["latency_steps"], rep["admission_wait_steps"]
    ttft = rep["ttft_steps"]
    print(f"gateway [{c['hw_mode']}, {c['device']}] {c['arch']}: "
          f"{c['n_requests']} requests over {rep['steps']} steps "
          f"({rep['busy_steps']} busy, occupancy "
          f"{rep['occupancy']:.2f}/{c['slots']}, "
          f"prefill chunk {c['prefill_chunk']})")
    print(f"  {rep['tokens_out']} tokens in {rep['wall_s']:.1f}s "
          f"({rep['tokens_per_s']:.1f} tok/s) | latency steps "
          f"p50={lat['p50']:.0f} p99={lat['p99']:.0f} | ttft steps "
          f"p50={ttft['p50']:.0f} p99={ttft['p99']:.0f} | admission wait "
          f"p50={wait['p50']:.0f} p99={wait['p99']:.0f}")
    fleet = rep.get("fleet")
    if fleet is not None:
        hw = fleet["hw"]
        alarms = sum(ch["alarms"] for ch in fleet["chips"])
        recals = sum(ch["recals"] for ch in fleet["chips"])
        print(f"  fleet: {len(fleet['chips'])} chips, {hw['frames']} "
              f"coalesced frames ({hw['frames_per_step']:.1f}/step), "
              f"{hw['hw_calls']} hw matmuls, {alarms} alarms, "
              f"{recals} recals")
        ap_rep = fleet.get("autopilot")
        if ap_rep is not None:
            forecast = ap_rep["load_forecast"]
            print(f"  autopilot: {ap_rep['proactive_recals']} proactive "
                  f"recals, deferred {ap_rep['deferred_trough']} (load) + "
                  f"{ap_rep['deferred_budget']} (budget), load forecast "
                  + ("none" if forecast is None else f"{forecast:.2f}"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
