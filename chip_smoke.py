#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases:

1. ``kernels`` — print the card's name and power limit, build both CUDA
   kernels from ``src/repro_torch/csrc`` (one nvcc each, in parallel), and
   hold each against its plain PyTorch version on the card: the reference
   package's kernel-test geometries, ragged row counts, and the full-width
   shapes of the main path, where each is also timed beside its bound and
   (for the PTC kernel) a one-call PyTorch yardstick.
2. ``parity`` — the reference quickstart's geometry (18 → 18 → 9, k = 9):
   dense pre-training, IC, PM, serving; metrics against the reference run
   and the served logits against the mapped weights.
3. ``full`` — the widest PTC layers the repository supports, VGG-8's
   classifier head (FC 4096 → 512 → 10, k = 9, bias-free): dense
   pre-training on 1024 rows, IC on its 25,992 blocks, PM of both
   weights, 8 served request batches of 1024 rows.  Every stage prints its wall time and both kernels' launch counts,
   which must be positive.

The last two lines are a ``{"kernels": [...]}`` JSON summary and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there are
counted over the last main path driven (full width, else parity), with
every count set to 0 just before it; they are null when no main path
ran.  Any failed check raises (exit code
not 0).  Without a CUDA device, or without the repository beside this
script, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("kernels", "parity", "full")
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 without tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the reference quickstart on a CPU (examples/quickstart.py): dense
# accuracy, IC identity MSE, PM layer-1 error after OSP, mapped accuracy
REFERENCE = dict(dense_acc=0.996, ic_mse=0.0352, err_osp=0.0061,
                 mapped_acc=0.993)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls (warm)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def ptxas_summary(log: str) -> list[str]:
    """One entry per kernel instantiation: template width, dtype,
    registers and (if any) spilled bytes, from ``nvcc -Xptxas -v``."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
            spill = ""
        elif int(re.search(r"(\d+) bytes spill stores", line).group(1)
                 if "spill stores" in line else 0):
            spill = ", spills: " + line.strip()
        elif "Used" in line and "registers" in line and name:
            width = re.search(r"kernelILi(\d+)E", name)
            dtype = "bf16" if "bfloat16" in name else "fp32"
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"K={width.group(1) if width else '?'} {dtype} "
                       f"{regs} regs{spill}")
            name = ""
    return out


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch) -> dict:
    from repro_torch.core import unitary as un
    from repro_torch.core.ptc import PTCParams, compose_weight, unblockize
    from repro_torch.kernels import (build, mesh_apply, mesh_apply_plain,
                                     ptc_block_matmul, ref)

    info = build.build(force=True)
    print(f"[build] nvcc sm_90a, {len(info['built'])} kernels in parallel: "
          f"{info['seconds']:.1f} s")
    for name in build.SOURCES:
        print(f"[build] {name} ptxas: " + " | ".join(ptxas_summary(
            (build.BUILD_DIR / f"{name}.ptxas.log").read_text())))

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    summary = {}

    # -- ptc_block_matmul ----------------------------------------------------
    def ptc_inputs(t, p, q, k, dtype):
        def mk(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return mk(t, q * k), mk(p, q, k, k), mk(p, q, k), mk(p, q, k, k)

    worst_rel, worst_abs = 0.0, 0.0
    shapes = [(8, 2, 3, 8), (64, 4, 4, 16), (32, 1, 1, 9), (16, 3, 2, 4),
              (128, 2, 2, 32),                      # reference test sweep
              (1000, 3, 5, 9), (37, 2, 3, 13),      # ragged T
              (9, 25992, 1, 9),                     # IC / PM probe
              (1024, 2, 57, 9), (1024, 57, 456, 9)]  # serve, W2 and W1
    for (t, p, q, k) in shapes:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
            if dtype == torch.bfloat16 and t * p * q > 1e6:
                continue
            x, u, s, v = ptc_inputs(t, p, q, k, dtype)
            y = ptc_block_matmul(x, u, s, v)
            yr = ref.ptc_block_matmul_ref(x, u, s, v)
            torch.cuda.synchronize()
            diff = float((y.float() - yr.float()).abs().max())
            rel = diff / (float(yr.float().abs().max()) + 1e-6)
            check(y.shape == yr.shape and bool(torch.isfinite(y).all()),
                  f"ptc_block_matmul {t, p, q, k}: bad output")
            check(rel < tol, f"ptc_block_matmul {(t, p, q, k)} {dtype}: "
                             f"rel err {rel:.2e} >= {tol}")
            if dtype == torch.float32:
                worst_rel = max(worst_rel, rel)
                worst_abs = max(worst_abs, diff)
    print(f"[check] ptc_block_matmul: {len(shapes)} shapes fp32 + bf16, "
          f"max rel err {worst_rel:.2e} (tol 1e-4 fp32, 6e-2 bf16), "
          f"max abs err {worst_abs:.2e}")

    timings = {}
    for label, (t, p, q, k), reps in (("serve W1", (1024, 57, 456, 9), 20),
                                      ("probe", (9, 25992, 1, 9), 50)):
        x, u, s, v = ptc_inputs(t, p, q, k, torch.float32)
        ms = cuda_ms(lambda: ptc_block_matmul(x, u, s, v), reps)
        plain = cuda_ms(lambda: ref.ptc_block_matmul_ref(x, u, s, v), 3)
        lib = cuda_ms(lambda: x @ unblockize(compose_weight(
            PTCParams(u, s, v))).T, reps)
        flops = t * p * q * (4 * k * k + k)
        nbytes = 4 * (x.numel() + u.numel() + s.numel() + v.numel()
                      + t * p * k)
        b_ms, b_by = bound_ms(flops, nbytes)
        timings[label] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by)
        print(f"[time] ptc_block_matmul {label} (T={t}, P={p}, Q={q}, k={k},"
              f" fp32): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"yardstick x @ unblockize(compose_weight).T {lib:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    summary["ptc_block_matmul"] = dict(
        max_abs_err=worst_abs, **timings["serve W1"])

    # -- mesh_apply ----------------------------------------------------------
    worst = 0.0
    for k in (2, 4, 8, 9, 13, 16):
        for kind in ("clements", "reck"):
            spec = un.mesh_spec(k, kind)
            ph = (torch.rand(spec.n_rot, generator=gen, device=dev) * 2 - 1) \
                * torch.pi
            d = torch.where(torch.rand(k, generator=gen, device=dev) < 0.5,
                            1.0, -1.0)
            for rows in (24, 1000):             # reference sweep, ragged
                x = torch.randn(rows, k, generator=gen, device=dev)
                y = mesh_apply(spec, ph, x, d)
                yr = mesh_apply_plain(spec, ph[None], x[None], d[None])[0]
                worst = max(worst, float((y - yr).abs().max()))
            # block-batched, as build_unitary drives it
            b = 37
            phb = torch.randn(b, spec.n_rot, generator=gen, device=dev) * 3
            db = torch.where(torch.rand(b, k, generator=gen, device=dev)
                             < 0.5, 1.0, -1.0)
            u = un.build_unitary(spec, phb, db)
            ur = mesh_apply_plain(spec, phb, torch.eye(k, device=dev)[None],
                                  db, transpose_out=True)
            worst = max(worst, float((u - ur).abs().max()))
    torch.cuda.synchronize()
    check(worst < 1e-5, f"mesh_apply: max abs err {worst:.2e} >= 1e-5")

    k, nb = 9, 2 * 25992
    spec = un.mesh_spec(k, "clements")
    phb = torch.rand(nb, spec.n_rot, generator=gen, device=dev) * 4 * torch.pi
    db = torch.where(torch.rand(nb, k, generator=gen, device=dev) < 0.5,
                     1.0, -1.0)
    eye = torch.eye(k, device=dev)[None]
    u = un.build_unitary(spec, phb, db)
    ur = mesh_apply_plain(spec, phb, eye, db, transpose_out=True)
    full_err = float((u - ur).abs().max())
    check(full_err < 1e-5, f"mesh_apply full width: max abs err "
                           f"{full_err:.2e} >= 1e-5")
    worst = max(worst, full_err)
    print(f"[check] mesh_apply: k in 2,4,8,9,13,16 x clements,reck, 24 and "
          f"1000 rows, batched; full width {nb} meshes x 9 rows: max abs "
          f"err {worst:.2e} (tol 1e-5)")
    ms = cuda_ms(lambda: un.build_unitary(spec, phb, db), 50)
    plain = cuda_ms(lambda: mesh_apply_plain(spec, phb, eye, db,
                                             transpose_out=True), 5)
    t_rot, layers = spec.n_rot, spec.n_layers
    # per mesh: one sincos (counted as 2 operations) per phase, 6 per
    # rotation per row, one sign multiply per wire per row
    flops = nb * (2 * t_rot + k * (6 * t_rot + k))
    nbytes = 4 * (nb * t_rot + nb * k + k * k + nb * k * k + layers * k)
    b_ms, b_by = bound_ms(flops, nbytes)
    print(f"[time] mesh_apply build_unitary ({nb} meshes x {k} rows, k={k}, "
          f"clements): kernel {ms:.4f} ms, plain {plain:.4f} ms, no "
          f"one-call yardstick, bound {b_ms:.4f} ms ({b_by})")
    summary["mesh_apply"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                                 library_ms=None, bound_ms=b_ms,
                                 bound_by=b_by)
    return summary


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def main_path(torch, name: str, geometry: tuple, **kw) -> tuple[dict, dict]:
    """Drive ``quickstart.run`` once with every launch count set to 0 just
    before it; return its result and the counts read just after it."""
    from repro_torch import quickstart
    from repro_torch.core.ptc import ptc_forward_fused
    from repro_torch.data.synthetic import synthetic_vision
    from repro_torch.kernels import build

    print(f"[{name}] {geometry[0]} -> {geometry[1]} -> {geometry[2]}, "
          f"k={geometry[3]}")
    t0 = time.perf_counter()
    build.reset_launch_counts()
    res = quickstart.run(*geometry, device="cuda",
                         log=lambda m: print(f"[{name}] {m}"), **kw)
    launches = dict(build.launch_counts)
    print(f"[{name}] wall {time.perf_counter() - t0:.1f} s, launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))
    for kernel, n in launches.items():
        check(n > 0, f"{name}: {kernel} was not launched on the main path")
    for stage in ("ic", "pm", "serve"):
        info = res["stages"][stage]
        counts = info["launches"]
        print(f"[{name}] stage {stage}: {info['seconds']:.2f} s, launches "
              + ", ".join(f"{k}={v}" for k, v in counts.items()))
        for kernel, n in counts.items():
            check(n > 0, f"{name}: {kernel} was not launched in {stage}")

    # served logits against the mapped weights through a dense product
    d_in, _, d_out, _ = geometry
    xs = torch.as_tensor(synthetic_vision(0, 99, 64, (d_in,), d_out)["x"],
                         device="cuda")
    logits = res["serve"](xs)
    p1, p2 = (pm.params for pm in res["pms"])
    ref_logits = ptc_forward_fused(p2, torch.relu(
        ptc_forward_fused(p1, xs, geometry[1])), d_out)
    rel = float((logits - ref_logits).abs().max()) \
        / float(ref_logits.abs().max())
    check(tuple(logits.shape) == (64, d_out)
          and bool(torch.isfinite(logits).all()), f"{name}: bad logits")
    check(rel < 1e-4, f"{name}: served logits vs mapped weights rel err "
                      f"{rel:.2e} >= 1e-4")
    print(f"[{name}] served logits vs dense product of the mapped weights: "
          f"rel err {rel:.2e} (tol 1e-4)")
    for key in ("dense_acc", "ic_mse", "mapped_acc", "served_acc",
                "dense_served_acc"):
        check(res[key] == res[key], f"{name}: {key} is NaN")
    return res, launches


def zo_busy_share(torch, res, steps: int = 20) -> None:
    """How busy the card is during an in-situ ZO job at full width: a
    short ``zo_refine`` on the mapped W1 chip, timed on the host, then
    run again under ``torch.profiler`` to sum its kernels' device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.mapping import default_pm_config
    from repro_torch.core.ptc import blockize

    driver = res["pms"][0].driver
    k = driver.k
    w_blocks = blockize(res["weights"][0], k).reshape(-1, k, k)
    cfg = default_pm_config(k * (k - 1) // 2)._replace(steps=steps)

    def job():
        driver.zo_refine(w_blocks, torch.Generator("cuda").manual_seed(0),
                         cfg)
        torch.cuda.synchronize()

    job()                                   # warm-up
    t0 = time.perf_counter()
    job()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        job()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    if busy_ms == 0:
        print("[profile] zo_refine: the profiler saw no device time; "
              "device busy share not measured")
        return
    print(f"[profile] zo_refine, {steps} ZCD steps on {driver.n_blocks} "
          f"blocks: host wall {wall_ms:.1f} ms ({wall_ms / steps:.2f} "
          f"ms/step), kernel time {busy_ms:.1f} ms in {launches} launches "
          f"({launches / steps:.0f}/step): device busy "
          f"{100 * busy_ms / wall_ms:.0f}% of the unprofiled wall")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print("[profile] top kernels: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
        for e in top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        ap.error(f"--phases must be drawn from {PHASES}")

    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    summary = kernel_phase(torch) if "kernels" in phases else {}
    # launches of each kernel on the last main path driven in this run
    # (full width if it ran, else parity); null when none was driven
    launches = dict.fromkeys(build.SOURCES)

    if "parity" in phases:
        res, launches = main_path(torch, "parity", (18, 18, 9, 9))
        # the reference quickstart's numbers (CPU run of examples/
        # quickstart.py); the port draws its own randomness, so it lands
        # near them, not on them
        check(res["dense_acc"] > REFERENCE["dense_acc"] - 0.02,
              f"parity dense accuracy {res['dense_acc']:.3f}")
        check(res["ic_mse"] < 2 * REFERENCE["ic_mse"],
              f"parity IC MSE {res['ic_mse']:.4f}")
        check(res["err_osp"][0] < 2 * REFERENCE["err_osp"],
              f"parity PM error {res['err_osp'][0]:.4f}")
        check(res["mapped_acc"] > REFERENCE["mapped_acc"] - 0.02,
              f"parity mapped accuracy {res['mapped_acc']:.3f}")
        print(f"[parity] reference (JAX quickstart, CPU): dense "
              f"{REFERENCE['dense_acc']}, IC MSE {REFERENCE['ic_mse']}, PM "
              f"osp {REFERENCE['err_osp']}, mapped {REFERENCE['mapped_acc']}")

    if "full" in phases:
        # input noise 6 (not the parity run's 0.8) keeps the 4096-wide
        # task from being trivially separable: dense held-out accuracy
        # is about 0.9, so the served accuracy can show a mapping loss
        res, launches = main_path(torch, "full", (4096, 512, 10, 9),
                                  noise=6.0, serve_batches=8,
                                  serve_rows=1024)
        print(f"[full] served accuracy {res['served_acc']:.4f} beside dense "
              f"pre-trained accuracy {res['dense_served_acc']:.4f} on the "
              f"same {8 * 1024} request rows (training rows: dense "
              f"{res['dense_acc']:.4f}, mapped {res['mapped_acc']:.4f})")
        check(res["served_acc"] >= res["dense_served_acc"] - 0.05,
              "full: served accuracy more than 0.05 below dense")
        zo_busy_share(torch, res)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)                     # name, power limit: as nvidia-smi has it
    sources = {"ptc_block_matmul": "src/repro/kernels/ptc_block_matmul.py:46",
               "mesh_apply": "src/repro/kernels/mesh_apply.py:45"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/csrc/{build.SOURCES[name]}",
             replaces=sources[name], launches=launches[name],
             max_abs_err=info["max_abs_err"], ms=info["ms"],
             plain_ms=info["plain_ms"], bound_ms=info["bound_ms"],
             bound_by=info["bound_by"], library_ms=info["library_ms"])
        for name, info in summary.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
