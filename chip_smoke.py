#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only

Phases:

1. ``kernels`` — print the card's name and power limit, build all four
   CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each, in
   parallel), and hold each against its plain PyTorch version on the
   card: the reference package's kernel-test geometries, ragged row
   counts, feedback masks of density 0, 0.5, 1 and btopk, and the
   full-width shapes of the main path, where each is also timed beside
   its bound, its plain version and a PyTorch yardstick.
2. ``parity`` — the reference quickstart's geometry (18 → 18 → 9, k = 9):
   dense pre-training, IC, PM, serving, subspace learning (SL) and serving
   with the trained Σ; metrics against the reference run and the served
   logits against the mapped weights.
3. ``full`` — the widest PTC layers the repository supports, VGG-8's
   classifier head (FC 4096 → 512 → 10, k = 9, bias-free): dense
   pre-training on 1024 rows, IC on its 25,992 blocks, PM of both
   weights, 8 served request batches of 1024 rows, SL, and the same
   batches served again after SL.
4. ``vgg8`` — the full VGG-8 (32 × 32 × 3, k = 9, blocked) trained for 30
   AdamW steps on Σ and biases through ``build_cnn_train_step`` with
   feedback and column sampling, on a fixed batch of 32; one step's
   gradients held against the same step through the plain versions.

Every stage of a main path prints its wall time and its launches of each
kernel, and must have launched each kernel it uses (``STAGE_KERNELS``).
The last two lines are a ``{"kernels": [...]}`` JSON summary and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there are
counted over the last quickstart path driven (full width, else parity),
with every count set to 0 just before it; they are null when no main path
ran.  Any failed check raises (exit code not 0).  Without a CUDA device,
or without the repository beside this script, it exits with code 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("kernels", "parity", "full", "vgg8")
# the kernels each stage of quickstart.run launches
STAGE_KERNELS = {
    "ic": ("mesh_apply", "ptc_block_matmul"),
    "pm": ("mesh_apply", "ptc_block_matmul"),
    "serve": ("ptc_block_matmul",),
    "sl": ("ptc_block_matmul", "sigma_grad", "feedback_matmul"),
    "serve_sl": ("ptc_block_matmul",),
}
# TPU kernel each CUDA kernel replaces (function, file:line)
REPLACES = {"ptc_block_matmul": "src/repro/kernels/ptc_block_matmul.py:46",
            "mesh_apply": "src/repro/kernels/mesh_apply.py:45",
            "sigma_grad": "src/repro/kernels/sigma_grad.py:43",
            "feedback_matmul": "src/repro/kernels/feedback_matmul.py:48"}
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 without tensor
# cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the reference quickstart on a CPU (examples/quickstart.py): dense
# accuracy, IC identity MSE, PM layer-1 error after OSP, mapped accuracy,
# subspace-trained accuracy
REFERENCE = dict(dense_acc=0.996, ic_mse=0.0352, err_osp=0.0061,
                 mapped_acc=0.993, sl_acc=0.996)


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


def rel_err(a, b) -> tuple[float, float]:
    """(max abs error, max abs error over the largest |b|)."""
    diff = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    scale = float(b.float().abs().max()) if b.numel() else 0.0
    return diff, diff / (scale + 1e-6)


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
        # the least work for y = x·Wᵀ: compose each W_pq = U diag(s) V*
        # once, then one dense product
        flops = 2 * k * k * t * p * q + (2 * k ** 3 + k * k) * p * q
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
    summary.update(backward_kernels(torch, gen))
    return summary


def backward_kernels(torch, gen) -> dict:
    """``sigma_grad`` and ``feedback_matmul`` against their plain versions,
    then timed at the training path's full-width shapes."""
    from repro_torch.core.ptc import (PTCParams, blockize, compose_weight,
                                      unblockize)
    from repro_torch.core.sparsity import SparsityConfig, feedback_mask
    from repro_torch.kernels import feedback_matmul, ref, sigma_grad

    dev = torch.device("cuda")

    def mk(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def masks(q, p):
        """density 0, 0.5 and 1 (scaled by 2, as the reference test), and
        a btopk α_W = 0.6 mask from the port's sampler."""
        for dens in (0.0, 0.5, 1.0):
            keep = torch.rand((q, p), generator=gen, device=dev) < dens
            yield f"density {dens}", keep.float() * 2.0
        energy = torch.rand((p, q), generator=gen, device=dev)
        yield "btopk 0.6", feedback_mask(
            gen, energy, SparsityConfig(alpha_w=0.6, feedback_mode="btopk"))

    shapes = [(16, 3, 2, 8), (32, 4, 4, 16), (8, 2, 2, 9), (16, 2, 3, 8),
              (64, 4, 4, 16), (32, 1, 2, 9),        # reference test sweep
              (100, 2, 3, 4), (129, 2, 2, 32),       # the other widths
              (37, 3, 5, 9), (1000, 3, 5, 13),       # ragged T
              (1024, 57, 456, 9),                    # FC W1 of VGG-8
              (32768, 8, 64, 9), (32768, 8, 3, 9)]   # VGG-8 conv l1, l0
    worst = {"sigma_grad": [0.0, 0.0], "feedback_matmul": [0.0, 0.0]}

    def record(name, what, out, want):
        diff, rel = rel_err(out, want)
        check(out.shape == want.shape and bool(torch.isfinite(out).all()),
              f"{name} {what}: bad output")
        check(rel < 1e-4, f"{name} {what}: rel err {rel:.2e} >= 1e-4")
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], diff)]

    for (t, p, q, k) in shapes:
        dy, x, u, s, v = mk(t, p * k), mk(t, q * k), mk(p, q, k, k), \
            mk(p, q, k), mk(p, q, k, k)
        ds = sigma_grad(dy, x, u, v)
        record("sigma_grad", (t, p, q, k), ds, ref.sigma_grad_ref(dy, x, u, v))
        check(torch.equal(ds, sigma_grad(dy, x, u, v)),
              f"sigma_grad {(t, p, q, k)}: two runs differ")
        for label, mask in masks(q, p):
            dx = feedback_matmul(dy, u, s, v, mask)
            record("feedback_matmul", f"{(t, p, q, k)} {label}", dx,
                   ref.feedback_matmul_ref(dy, u, s, v, mask))
            if label == "density 0.0":
                check(int(torch.count_nonzero(dx)) == 0,
                      f"feedback_matmul {(t, p, q, k)}: density 0 is not an "
                      f"exact zero")
        torch.cuda.synchronize()
    for name, (rel, diff) in worst.items():
        print(f"[check] {name}: {len(shapes)} shapes"
              + (" x masks of density 0, 0.5, 1 and btopk 0.6"
                 if name == "feedback_matmul" else ", deterministic")
              + f", max rel err {rel:.2e} (tol 1e-4), max abs err "
                f"{diff:.2e}")

    timings = {}
    for label, (t, p, q, k) in (("FC W1", (1024, 57, 456, 9)),
                                ("conv l1", (32768, 8, 64, 9))):
        dy, x, u, s, v = mk(t, p * k), mk(t, q * k), mk(p, q, k, k), \
            mk(p, q, k), mk(p, q, k, k)
        # sigma_grad: the work is the whole (P, Q) grid over all T rows
        ms = cuda_ms(lambda: sigma_grad(dy, x, u, v), 20)
        plain = cuda_ms(lambda: ref.sigma_grad_ref(dy, x, u, v), 3)

        def library():        # ds in one PyTorch call
            return torch.einsum("tpi,tqj,pqik,pqkj->pqk", dy.view(t, p, k),
                                x.view(t, q, k), u, v)

        def fused_bwd():      # the fused mode's ds: δyᵀx, block diagonals
            dwb = blockize(dy.T @ x, k)
            return torch.einsum("pqil,pqil->pqi", torch.einsum(
                "pqji,pqjl->pqil", u, dwb), v)
        _, lib_rel = rel_err(library(), ref.sigma_grad_ref(dy, x, u, v))
        lib = cuda_ms(library, 20)
        yard = cuda_ms(fused_bwd, 20)
        # the least work: M_pq = δy_pᵀ x_q over all rows (the dense δyᵀx),
        # then diag(U_pqᵀ M_pq V*_pqᵀ) once per block
        flops = 2 * k * k * t * p * q + (2 * k ** 3 + 2 * k * k) * p * q
        nbytes = 4 * (dy.numel() + x.numel() + u.numel() + v.numel()
                      + p * q * k)
        b_ms, b_by = bound_ms(flops, nbytes)
        timings[("sigma_grad", label)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by)
        print(f"[time] sigma_grad {label} (T={t}, P={p}, Q={q}, k={k}, "
              f"fp32): kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
              f"one torch.einsum (opt_einsum "
              f"{torch.backends.opt_einsum.is_available()}, rel err "
              f"{lib_rel:.1e}) {lib:.4f} ms, fused-mode backward (dy.T @ x "
              f"by cuBLAS + 2 einsums) {yard:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")

        # feedback_matmul with the btopk α_W = 0.6 mask of the SL path
        mask = feedback_mask(gen, torch.rand((p, q), generator=gen,
                                             device=dev),
                             SparsityConfig(alpha_w=0.6))
        kept = int(torch.count_nonzero(mask))
        ms = cuda_ms(lambda: feedback_matmul(dy, u, s, v, mask), 20)
        plain = cuda_ms(lambda: ref.feedback_matmul_ref(dy, u, s, v, mask), 3)
        w = unblockize(compose_weight(PTCParams(u, s, v))
                       * mask.T[:, :, None, None])
        lib = cuda_ms(lambda: dy @ w, 20)
        # the least work: compose each kept W_pq once, then its product
        flops = kept * (2 * k * k * t + 2 * k ** 3 + k * k)
        nbytes = 4 * (dy.numel() + kept * (2 * k * k + k) + mask.numel()
                      + t * q * k)
        b_ms, b_by = bound_ms(flops, nbytes)
        timings[("feedback_matmul", label)] = dict(
            ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
            bound_by=b_by)
        print(f"[time] feedback_matmul {label} (T={t}, P={p}, Q={q}, k={k}, "
              f"btopk 0.6: {kept} of {p * q} blocks, fp32): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, yardstick dy @ masked "
              f"unblockize(W) (one cuBLAS call) {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    return {name: dict(max_abs_err=worst[name][1],
                       **timings[(name, "FC W1")])
            for name in ("sigma_grad", "feedback_matmul")}


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def main_path(torch, name: str, geometry: tuple, **kw) -> tuple[dict, dict]:
    """Drive ``quickstart.run`` once with every launch count set to 0 just
    before it; return its result and the counts read just after it."""
    from repro_torch import quickstart
    from repro_torch.core.ptc import PTCParams, ptc_forward_fused
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
    for stage, kernels in STAGE_KERNELS.items():
        info = res["stages"][stage]
        counts = info["launches"]
        print(f"[{name}] stage {stage}: {info['seconds']:.2f} s, launches "
              + ", ".join(f"{k}={v}" for k, v in counts.items()))
        for kernel in kernels:
            check(counts[kernel] > 0,
                  f"{name}: {kernel} was not launched in {stage}")

    # served logits against the mapped weights through a dense product
    d_in, _, d_out, _ = geometry
    xs = torch.as_tensor(synthetic_vision(0, 99, 64, (d_in,), d_out)["x"],
                         device="cuda")
    logits = res["serve"](xs)
    p1, p2 = (PTCParams(pm.params.u, s, pm.params.v)     # Σ after SL
              for pm, s in zip(res["pms"], res["sl_sigma"]))
    ref_logits = ptc_forward_fused(p2, torch.relu(
        ptc_forward_fused(p1, xs, geometry[1])), d_out)
    rel = float((logits - ref_logits).abs().max()) \
        / float(ref_logits.abs().max())
    check(tuple(logits.shape) == (64, d_out)
          and bool(torch.isfinite(logits).all()), f"{name}: bad logits")
    check(rel < 1e-4, f"{name}: served logits vs mapped weights rel err "
                      f"{rel:.2e} >= 1e-4")
    print(f"[{name}] served logits vs dense product of the mapped weights "
          f"with the SL-trained Σ: "
          f"rel err {rel:.2e} (tol 1e-4)")
    for key in ("dense_acc", "ic_mse", "mapped_acc", "served_acc",
                "dense_served_acc", "sl_acc", "served_acc_sl"):
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


# ---------------------------------------------------------------------------
# phase 4: VGG-8 training
# ---------------------------------------------------------------------------


def vgg8_phase(torch, steps: int = 30, batch: int = 32) -> None:
    """Train the full VGG-8 on Σ and biases with sampled in-situ gradients;
    check losses, launches per step, and one step's gradients against the
    same step with the backward through the plain versions."""
    from repro_torch.core import subspace
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.data.synthetic import synthetic_vision
    from repro_torch.kernels import build, ref
    from repro_torch.models.cnn import (VGG8, build_cnn_train_step,
                                        cnn_masks, init_cnn)
    from repro_torch.models.layers import trainable_mask
    from repro_torch.optim.optimizers import (AdamWConfig, apply_updates,
                                              init_opt_state)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    params = init_cnn(gen, VGG8)
    data = synthetic_vision(0, 0, batch, VGG8.in_shape, VGG8.n_classes)
    xb = {"x": torch.as_tensor(data["x"], device=dev),
          "y": torch.as_tensor(data["y"], dtype=torch.long, device=dev)}
    scfg = SparsityConfig(alpha_w=0.6, alpha_c=0.6)
    step = build_cnn_train_step(VGG8, scfg)
    n_blocks = sum(p["s"].shape[0] * p["s"].shape[1] for p in params.values())
    print(f"[vgg8] VGG-8 {VGG8.in_shape} k={VGG8.ptc.k} blocked, "
          f"{len(params)} PTC layers, {n_blocks} blocks; batch {batch}, "
          f"alpha_w 0.6, alpha_c 0.6, AdamW lr 2e-3, {steps} steps")

    # one step, shared masks: the backward kernels against their plain
    # versions.  Both runs share the forward (the PTC kernel, bit for bit),
    # so every ReLU gates alike; a forward rounded otherwise (say on the
    # host) flips the units that sit within rounding of zero, which moves
    # the first layers' Σ-gradients by up to ~1e-3 relative.
    masks = cnn_masks(params, VGG8, batch, gen, scfg)
    t0 = time.perf_counter()
    loss_k, grads_k = step(params, xb, masks=masks)
    kernels = subspace.sigma_grad, subspace.feedback_matmul
    before = dict(build.launch_counts)
    subspace.sigma_grad = ref.sigma_grad_ref
    subspace.feedback_matmul = ref.feedback_matmul_ref
    try:
        loss_p, grads_p = step(params, xb, masks=masks)
    finally:
        subspace.sigma_grad, subspace.feedback_matmul = kernels
    torch.cuda.synchronize()
    check(all(build.launch_counts[k] == before[k]
              for k in ("sigma_grad", "feedback_matmul")),
          "vgg8: the plain-version step launched a backward kernel")
    check(float(loss_k) == float(loss_p), "vgg8: the two forwards differ")
    worst = 0.0
    for name, leaves in grads_p.items():
        for leaf, g in leaves.items():
            _, rel = rel_err(grads_k[name][leaf], g)
            check(rel < 1e-4, f"vgg8: {name}.{leaf} gradient rel err "
                              f"{rel:.2e} >= 1e-4 against the plain versions")
            worst = max(worst, rel)
    print(f"[vgg8] one step, shared masks and forward, backward kernels vs "
          f"plain versions: loss {float(loss_k):.6f}, every ds and bias "
          f"gradient within rel {worst:.2e} (tol 1e-4)  "
          f"[{time.perf_counter() - t0:.1f} s]")

    tr = trainable_mask(params)
    keys = [(name, leaf) for name, layer in params.items() for leaf in layer
            if tr[name][leaf]]
    state = dict(opt=init_opt_state([params[n][l] for n, l in keys]))
    ocfg = AdamWConfig(lr=2e-3)

    def train_step() -> float:
        loss, grads = step(params, xb, gen)
        new, state["opt"], _ = apply_updates(
            [params[n][l] for n, l in keys], [grads[n][l] for n, l in keys],
            state["opt"], ocfg)
        for (n, l), val in zip(keys, new):
            params[n][l] = val
        return float(loss)

    losses, step_s = [], []
    build.reset_launch_counts()
    for i in range(steps):
        before = dict(build.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(train_step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        for kernel in STAGE_KERNELS["sl"]:
            check(build.launch_counts[kernel] > before[kernel],
                  f"vgg8: {kernel} not launched in step {i}")
    counts = dict(build.launch_counts)
    check(all(l == l and abs(l) < float("inf") for l in losses),
          f"vgg8: non-finite loss {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    median_ms = 1e3 * sorted(step_s[1:])[(steps - 1) // 2]
    print(f"[vgg8] losses {' '.join(f'{l:.4f}' for l in losses)}")
    print(f"[vgg8] mean loss of the first 5 steps {first:.4f}, of the last 5 "
          f"{last:.4f}; step time (loss, gradients, AdamW) median "
          f"{median_ms:.2f} ms over steps 2-{steps}, first step "
          f"{1e3 * step_s[0]:.2f} ms; launches over {steps} steps "
          + ", ".join(f"{k}={v}" for k, v in counts.items()))
    check(last < first, "vgg8: the loss did not fall")

    # where a step's device time goes: 3 steps under the profiler, their
    # kernel time against the unprofiled median step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            train_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 3e3
    if busy_ms == 0:
        print("[profile] vgg8: the profiler saw no device time; not measured")
        return
    print(f"[profile] vgg8 train step, 3 profiled steps: kernel time "
          f"{busy_ms:.2f} ms/step in {sum(e.count for e in kernels) / 3:.0f} "
          f"launches/step: device busy {100 * busy_ms / median_ms:.0f}% of "
          f"the unprofiled median step")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print("[profile] top kernels per step: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 3e3:.3f} ms x"
        f"{e.count / 3:.0f}" for e in top))


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
        check(res["sl_acc"] >= REFERENCE["sl_acc"] - 0.02,
              f"parity SL accuracy {res['sl_acc']:.3f}")
        print(f"[parity] SL accuracy {res['sl_acc']:.4f}; served after SL "
              f"{res['served_acc_sl']:.4f} (before {res['served_acc']:.4f})")
        print(f"[parity] reference (JAX quickstart, CPU): dense "
              f"{REFERENCE['dense_acc']}, IC MSE {REFERENCE['ic_mse']}, PM "
              f"osp {REFERENCE['err_osp']}, mapped {REFERENCE['mapped_acc']}, "
              f"SL {REFERENCE['sl_acc']}")

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
        print(f"[full] SL accuracy {res['sl_acc']:.4f} on the training rows; "
              f"served accuracy after SL {res['served_acc_sl']:.4f} beside "
              f"{res['served_acc']:.4f} before SL (dense "
              f"{res['dense_served_acc']:.4f})")
        check(res["served_acc_sl"] >= res["dense_served_acc"] - 0.05,
              "full: served accuracy after SL more than 0.05 below dense")
        zo_busy_share(torch, res)

    if "vgg8" in phases:
        vgg8_phase(torch)

    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)                     # name, power limit: as nvidia-smi has it
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source=f"src/repro_torch/csrc/{build.SOURCES[name]}",
             replaces=REPLACES[name], launches=launches[name],
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
