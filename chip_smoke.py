#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases kernels     # build + kernel checks only
    python3 chip_smoke.py --phases kernels,blocked_lm
                                               # the k = 128 blocked path
    python3 chip_smoke.py --phases kernels,vgg8 --parent DIR
                                               # + an earlier tree's PTC
                                               # and CUDA-core prefill
                                               # kernels timed beside
    python3 chip_smoke.py --phases tables,serve [--budget normal]
                                               # the paper's tables and
                                               # the solo serve path
    python3 chip_smoke.py --phases families    # the ssm, hybrid and MoE
                                               # families on the serving
                                               # paths
    python3 chip_smoke.py --phases train       # LM training: olmo-1b's
                                               # blocked update step,
                                               # the remat policies,
                                               # whisper-base, the vlm
    python3 chip_smoke.py --phases train,examples
                                               # + the train_lm and
                                               # onchip_transfer examples
    python3 chip_smoke.py --phases closed_loop # drift, alarms and repairs
                                               # on a two-chip fleet
    python3 chip_smoke.py --phases hw_serve    # whisper-base's PTC layers
                                               # served through two chips
    python3 chip_smoke.py --phases driver      # the same over the socket
                                               # transport, the driver
                                               # overhead benchmark
    python3 chip_smoke.py --phases e2e_accuracy
                                               # the served LM's task
                                               # accuracy under drift
    python3 chip_smoke.py --phases hw_serve,driver,e2e_accuracy,serving_gateway
                                               # + the serving_gateway
                                               # benchmark, then
                                               # check_regression over
                                               # the four JSONs

Phases:

1. ``kernels`` — print the card's name and power limit, build the CUDA
   kernels of all seven TPU kernels from ``src/repro_torch/csrc`` (one
   nvcc per source, all in parallel, while qwen3-4b's parameters for the
   gateway and serve phases are seeded on the card and staged in host
   memory; prefill attention has two routes,
   the tensor-core kernel for bf16 at head dims 64 and 128 and the
   CUDA-core kernel for the rest; ``ptc_block_matmul`` three, the product
   route, the per-block route for Q = 1 and few rows, and the wide route
   for k > 32, each checked at every shape it can take; ``sigma_grad``,
   ``feedback_matmul`` and ``mesh_apply`` each a wide route for k > 32;
   the three PTC kernels a tensor-core route for bf16 at k 64 and 128,
   timed beside the CUDA-core wide route forced on the same inputs and
   beside fp32 and bf16 one-call yardsticks; the three a 3xTF32
   tensor-core route for fp32 at k 64 and 128, timed in turns with the
   CUDA-core wide route forced on the same fp32 inputs and beside fp32
   and one-pass TF32 one-call yardsticks; ``mesh_apply`` an unrolled
   wide route at k 64 and 128, timed in turns with the list-driven wide
   kernel forced on the same meshes), and hold each
   against its plain PyTorch version on the card: the reference
   package's kernel-test
   geometries, ragged row counts, feedback masks of density 0, 0.5, 1
   and btopk, k of 33, 64, 100 and 128 in fp32 and bf16, meshes of k 2
   to 32, duplicate
   scatter targets, the prefill (blk, window, cap)
   sweep on both routes, and the full-width shapes of the main paths,
   where each is also timed beside its bound, its plain version and a
   PyTorch yardstick (and, with ``--parent``, the earlier tree's
   ``ptc_block_matmul``, ``sigma_grad`` and CUDA-core
   ``prefill_attention``).
2. ``parity`` — the reference quickstart's geometry (18 → 18 → 9, k = 9):
   dense pre-training, IC, PM, serving, subspace learning (SL) and serving
   with the trained Σ; metrics against the reference run and the served
   logits against the mapped weights.
3. ``full`` — the widest PTC layers the repository supports, VGG-8's
   classifier head (FC 4096 → 512 → 10, k = 9, bias-free): dense
   pre-training on 1024 rows, IC on its 25,992 blocks, PM of both
   weights, 8 served request batches of 1024 rows, SL, and the same
   batches served again after SL.
4. ``closed_loop`` — the closed loop (``repro_torch.runtime``): a fleet
   of 2 virtual chips on the card, each carrying VGG-8's head (W1 and W2
   as tenants 0 and 1, 26,106 blocks of k = 9; the full phase's
   weights, else seeded at its shapes), post-IC noise, OU drift at
   ``CLOSED_LOOP_SIGMA``, the demo's monitor and repair policy; 120
   ticks, each serving 1,024 rows round-robin over the tenants, then
   ``router.tick()`` and the true distances.  The deploy, tick and
   repair stages must launch the routes ``STAGE_KERNELS`` names; an
   alarm must fire and every repair clear below 0.02 with the co-tenant
   bit-identical across it; no batch dropped; ``forward_many`` equal to
   separate forwards bit for bit; the same loop from the same deployed
   state with the kernels swapped for their plain versions through its
   first repair: the same timeline, distances and serve errors within
   ``CLOSED_LOOP_TOL``.
5. ``vgg8`` — the full VGG-8 (32 × 32 × 3, k = 9, blocked) trained for 30
   AdamW steps on Σ and biases through ``build_cnn_train_step`` with
   feedback and column sampling, on a fixed batch of 32; one step's
   gradients held against the same step through the plain versions.
6. ``blocked_lm`` — olmo-1b's seven PTC linears of one decoder layer
   (q, k, v, o 2048 → 2048; gate, up 2048 → 8192; down 8192 → 2048) in
   blocked mode at k = 128 with bf16 bases, T = 4096: one step, forward
   and autograd through ``apply_ptc_linear`` with feedback and column
   sampling, on the three tensor-core routes alone, held against the
   same step through the
   plain versions (the Σ-gradients' least-squares scale within 5e-4 of
   1), its device time by kernel from ``torch.profiler``; the same step
   with fp32 bases on the three 3xTF32 routes, held at 1e-4 and profiled
   the same way; then the up projection's 1,024 blocks realized through
   ``realized_unitaries`` (2,048 reck meshes of k = 128 on the unrolled
   wide mesh route).
7. ``gateway`` — qwen3-4b at full width (d_model 2560, k = 128 fused PTC
   with bf16 bases), depth cut to ``QWEN_LAYERS`` (9 of 36), serving 16 seeded Poisson requests through
   the continuous-batching gateway with paged KV and chunked prefill
   (chunk 64); every busy step must launch the gather, the scatter and
   the prefill attention, one step is held against the plain versions,
   and at smoke width (fp32) chunked prefill must emit the one-token
   path's tokens.
8. ``serve`` — the solo serve path (``repro_torch.launch.serve.run``,
   greedy decode against the dense KV cache) at qwen3-4b full width in
   bf16 (``QWEN_LAYERS``), batch 4, prompt 64, 32 new tokens: tokens/s and the step wall;
   its last-prompt logits against the gateway's for the same prompts
   (``SERVE_TOL``), and at smoke width in fp32 every request served alone
   emits the gateway's tokens.
9. ``families`` — the ssm, hybrid and MoE families on the serving
   paths, none of which launches a kernel of the seven (the reference
   computes the scan, the recurrence and the MoE dispatch in plain jnp):
   falcon-mamba-7b at full width, depth cut to 2 of 64 layers (bf16
   bases, k = 128, seeded on the card) through ``launch.serve.run`` (batch 4,
   prompt 32, 32 new tokens) and the gateway (8 slots, prefill chunk 1,
   8 Poisson requests), timed; the gateway's last-prompt logits against
   the solo path's (``SERVE_TOL``); one layer's chunked scan against 64
   steps of its recurrence (``SCAN_TOL``); qwen3-moe-30b-a3b at full
   width, depth cut to 1 of 48 layers, solo serve timed and one layer's
   dispatch against the dense combine of each token's top-8 experts
   (``MOE_TOL``); at smoke width in fp32, falcon-mamba's requests served
   alone against its gateway, and jamba, qwen3-moe and moonshot stepped
   on the card and on the CPU from one state (``FAMILY_SMOKE_TOL``).
10. ``tables`` — the paper's six table benchmarks through
   ``repro_torch.benchmarks.run`` on the card (``--budget``, default
   ``quick``; ``normal`` adds k = 24 and 32 and about 7 minutes): each
   table's rows, wall and launches; Fig. 8 and Table 3
   recomputed with the kernels swapped for their plain versions on the
   same draws (``TABLE_TOL``), the ZO tables held to ``TABLE_LIMITS``
   beside the reference's CPU rows, and the card's busy share from a
   profiled slice of each benchmark.
11. ``train`` — LM training through ``launch/steps.py::
   build_update_step``: olmo-1b at full width in blocked mode, depth cut
   to ``OLMO_LAYERS`` (4 of 16 layers, k = 128, bf16 bases, 1 x 4096
   tokens, alpha_w = alpha_c = 0.6, each layer recomputed in the
   backward), four AdamW steps whose loss must fall, each launching the
   three tensor-core routes (2 n forwards, n Σ-gradients, n feedbacks for
   its n PTC linears: 56, 28, 28) and no other PTC route, a
   warm step profiled; one training step against its plain versions
   (``TRAIN_LOSS_TOL``; the Σ-gradients per leaf, ``TRAIN_SIGMA_TOL``,
   and per layer, ``TRAIN_SIGMA_LAYER_TOL``) and 2 of its 16 layers with
   fp32 bases on the 3xTF32 routes (``TRAIN_FP32_TOL``); whisper-base (6
   + 6 layers, k = 64, 8 x 512 tokens) two steps on the k = 64
   tensor-core routes, one step against its plain versions (the same
   limits), and its solo serve path with ``enc_out``;
   llama-3.2-vision-11b at full width, 5 of 40 layers, served through
   ``launch.serve.run`` with 1,024 image tokens, its teacher-forced
   logits against ``forward``'s (``DECODE_TOL``); ``launch.train`` at
   smoke:olmo-1b with a checkpoint resume.  Then, on the seeded olmo-1b
   parameters, one training step's gradients under each remat policy
   ("full", "dots", "none"): in blocked mode the tensor-core routes
   launched (2 n, n, n) times under "full" and "dots" and (n, n, n) under
   "none" for its n PTC linears, in fused mode (olmo-1b's own config) no
   PTC kernel; in both modes "dots" bit-equal to "full" (loss and every
   Σ-gradient leaf), each policy's warm wall and peak memory, and in
   fused mode the peak under "dots" strictly between "full"'s and
   "none"'s.
11b. ``examples`` — the two example entry points on the card:
   ``repro_torch.onchip_transfer.run`` (paper Fig. 14 at its own sizes:
   36 → 36 → 9, k = 9; PM must launch the mesh and each Σ-training run
   the PTC forward, Σ-gradient and feedback kernels), again with the
   kernels swapped for their plain versions on the same draws (Σ after
   each run's first 10 steps within ``TRANSFER_SIGMA_TOL`` of its largest
   entry, each final accuracy within ``TRANSFER_ACC_TOL``); then
   ``repro_torch.train_lm.run`` at the ``100m`` preset, 300 steps if a
   20-step probe says they fit in ``TRAIN_LM_BUDGET_S`` (else 100), whose
   last-10 mean loss must fall below its first-10.
12. ``hw_serve`` — hardware-in-the-loop LM serving (run after
   ``closed_loop``): leg A serves whisper-base at full width, ``HW_LAYERS``
   of its 6 decoder layers (d_model 512, d_ff 2048, k = 64, fp32 bases)
   through ``launch.serve.run --hw-logits`` on 2 chips of k = 8 (11
   tenants and 81,920 blocks a chip per layer), batch 4, prompt 16, 16 new
   tokens, σ_drift 0: 7 frames a step per layer, no shadow call, the
   deploy, step and tick stages
   launching the routes ``STAGE_KERNELS`` names; the routed tokens
   teacher-forced through the shadow transfer of each step's chip, and
   the first 4 steps recomputed from the deployed state with the plain
   versions, both within ``HW_TOL`` of the largest logit.  Leg B serves
   one of the six decoder layers for 64 steps under drift
   (``CLOSED_LOOP_SIGMA``) with the closed loop on: an alarm, repairs that
   clear below the alarm threshold, every pass accounted.  Leg C runs the
   port's ``fleet_autopilot`` benchmark through its runner (its gates
   beside the reference's CPU values; its gateway leg must complete with
   load samples) and chunked prefill through the hw gateway (chunk 4
   emits the chunk-1 tokens in fewer frames).
13. ``driver`` — the driver plane (run after ``hw_serve``): leg A again,
   every chip a ``repro_torch.hw.server`` child on the same card over the
   socket transport, bit for bit against the twin transport's run (the
   hw_serve phase's, else run here): logits, tokens and every chip's PTC
   calls equal (else the first step that parts, and by how much), the
   children's kernel launches counted from their stderr, frames and wire
   bytes a step; ``driver_overhead`` at ``quick`` through the port's
   runner (per-op times on the three transports, the batch, async and
   concurrent sweeps, every bit-identity check); one seeded session of
   IC, PM, 30 drifting ticks and a recalibration on the twin, subprocess
   and socket transports, equal on the card; the driver_overhead gate
   ``v4_socket_batch64_within_2x_twin`` must hold.
14. ``e2e_accuracy`` — the port's ``e2e_accuracy`` benchmark at ``quick``
   through its runner, at the reference's configuration, none of it cut
   (smoke:qwen3-4b trained 200 AdamW steps on the Markov stream, every
   PTC layer a tenant of 2 chips of k = 8; σ_drift 0.004, 0.008 and 0.014
   with the closed loop on and off): its four gates must hold (route ≡
   shadow tokens at σ = 0 on the untrained model, twin ≡ subprocess ≡
   socket logits bit for bit, the open loop degrading monotonically, the
   closed loop's tail within 0.01 of σ = 0's), its layer and frame counts
   equal the committed reference JSON's, and ``mesh_apply`` and both
   ``ptc_block_matmul`` routes launch in this process and in the
   transport leg's server children; the training loss, the accuracies,
   alarms and recals printed beside the reference's CPU run (readings,
   not gates), each run's wall, the socket children's start and close
   walls, and where route and shadow part (with the top-2 margin there)
   if they do.  Then a repair's search at the benchmark's size, replayed
   as CUDA graphs, against ``zo_minimize``: the same bits, and the
   launches its replays count are the eager loop's (2 + 2 steps meshes,
   1 + 2 steps probes).
15. ``serving_gateway`` — the port's ``serving_gateway`` benchmark at
   ``quick`` through its runner, at the reference's sizes
   (smoke:qwen3-4b, 2 chips of k = 8, 4 slots): tokens/s a chip
   sequential against the gateway, TTFT, latency, the drift point, each
   leg's wall, the socket server children's start and close walls, the
   launches; its nine gates must hold and its virtual-step metrics equal
   the committed reference JSON; then ``check_regression`` over the
   JSONs of this invocation's serving_gateway, e2e_accuracy, driver and
   hw_serve phases, each ``--require``d: plain against an empty baseline
   (every gate), and ``--self-test`` (the degraded copy must be
   rejected).

The budget: the whole default run is held within half the 1,200 s limit
(600 s); only where a phase does not fit may it grow to 750 s (5/8 of the
limit), and beyond that an earlier path's depth is cut, ``QWEN_LAYERS``
first (9 of 36, not below 4).  ``OLMO_LAYERS``,
``DRIVER_OVERHEAD_REPEATS`` and every benchmark's own configuration are
not cut: their checks and gates are defined on them.

Every stage of a main path prints its wall time and its launches of each
kernel, and must have launched each kernel it uses (``STAGE_KERNELS``),
and of ``ptc_block_matmul``'s two routes only the one its entry names.
The last two lines are a ``{"kernels": [...]}`` JSON summary and
``{"ok": true, "device": {...}}``.  A kernel's ``launches`` there are
counted over its main path with every count set to 0 just before it: the
PTC kernels over the last quickstart path driven (full width, else
parity), the tensor-core routes over one olmo-1b update step of the
train phase (else the blocked_lm bf16 step), the
3xTF32 and CUDA-core wide routes over its fp32 step (which launches the
CUDA-core routes no more), the two wide mesh routes over its realization
(which launches the list-driven one no more), the serving kernels over
the gateway's
qwen3-4b run, the CUDA-core prefill route (which that bf16 run never
takes) over the smoke-width fp32 gateways, and the k <= 32 PTC kernels
over the closed loop's kernel run, else the tables phase, where no
quickstart path ran (else the driver phase's server children over its
leg A, counted from their stderr); they are null when that path did not
run.  Any failed check raises (exit code not
0).  Without a CUDA device, or without the repository beside this script,
it exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("kernels", "parity", "full", "closed_loop", "hw_serve", "driver",
          "vgg8", "blocked_lm", "train", "examples", "gateway", "serve",
          "families", "tables", "e2e_accuracy", "serving_gateway")
# the kernels each stage of quickstart.run launches, and each busy step of
# serving gateway.  ptc_block_matmul has two routes, each counted under its
# own name: the IC/PM probes take the per-block route
# (ptc_block_matmul_perblock), serving and SL the product route
# (ptc_block_matmul); a stage must launch the route it names and not the
# other
STAGE_KERNELS = {
    "ic": ("mesh_apply", "ptc_block_matmul_perblock"),
    "pm": ("mesh_apply", "ptc_block_matmul_perblock"),
    "serve": ("ptc_block_matmul",),
    "sl": ("ptc_block_matmul", "sigma_grad", "feedback_matmul"),
    "serve_sl": ("ptc_block_matmul",),
    "gateway": ("paged_gather", "paged_scatter", "prefill_attention"),
    # one LM update step in blocked mode with bf16 bases at k 64 or 128
    "train": ("ptc_block_matmul_wide_tc", "sigma_grad_wide_tc",
              "feedback_matmul_wide_tc"),
    # the closed loop: deploying a fleet (PM's readout and basis
    # readbacks), its ticks (serving on the product route, health probes
    # on the per-block route, the realizations of drift and the true
    # distances) and its repair jobs (the warm ZO job's probes, the OSP
    # readback, the clearing probe)
    "cl_deploy": ("mesh_apply", "ptc_block_matmul_perblock"),
    "cl_tick": ("mesh_apply", "ptc_block_matmul", "ptc_block_matmul_perblock"),
    "cl_recal": ("mesh_apply", "ptc_block_matmul_perblock"),
    # hardware-in-the-loop serving: the deploy (PM's readouts and basis
    # readbacks, the shadow's readback), a routed decode step's PTC layers
    # (each tenant's realization and its product over the tenant's grid)
    # and the ticks between steps (health probes on the per-block route)
    "hw_deploy": ("mesh_apply", "ptc_block_matmul_perblock"),
    "hw_step": ("mesh_apply", "ptc_block_matmul"),
    "hw_tick": ("mesh_apply", "ptc_block_matmul_perblock"),
    # the onchip_transfer example: PM realizes both layers' meshes and
    # reads them back (OSP) on the per-block route; each Σ-only training
    # run takes the blocked linear's forward (the product route, held-out
    # evaluations included) and its in-situ backward
    "transfer_pm": ("mesh_apply", "ptc_block_matmul_perblock"),
    "transfer_sigma": ("ptc_block_matmul", "sigma_grad", "feedback_matmul"),
}
PTC_ROUTES = ("ptc_block_matmul", "ptc_block_matmul_perblock")
QUICKSTART_STAGES = ("ic", "pm", "serve", "sl", "serve_sl")
CLOSED_LOOP_STAGES = ("cl_deploy", "cl_tick", "cl_recal")
CLOSED_LOOP_KERNELS = ("mesh_apply", "ptc_block_matmul",
                       "ptc_block_matmul_perblock")
# the kernels of each main path: quickstart.run, and the gateway
QUICKSTART_KERNELS = ("mesh_apply", "ptc_block_matmul",
                      "ptc_block_matmul_perblock", "sigma_grad",
                      "feedback_matmul")
GATEWAY_KERNELS = STAGE_KERNELS["gateway"]
# TPU kernel each CUDA kernel replaces (function, file:line)
REPLACES = {"ptc_block_matmul": "src/repro/kernels/ptc_block_matmul.py:46",
            "ptc_block_matmul_perblock":
                "src/repro/kernels/ptc_block_matmul.py:46",
            "mesh_apply": "src/repro/kernels/mesh_apply.py:45",
            "sigma_grad": "src/repro/kernels/sigma_grad.py:43",
            "feedback_matmul": "src/repro/kernels/feedback_matmul.py:48",
            "paged_gather": "src/repro/kernels/paged_kv.py:45",
            "paged_scatter": "src/repro/kernels/paged_kv.py:79",
            "prefill_attention": "src/repro/kernels/prefill_attn.py:88",
            "prefill_attention_cudacore":
                "src/repro/kernels/prefill_attn.py:88",
            "ptc_block_matmul_wide": "src/repro/kernels/ptc_block_matmul.py:46",
            "sigma_grad_wide": "src/repro/kernels/sigma_grad.py:43",
            "feedback_matmul_wide": "src/repro/kernels/feedback_matmul.py:48",
            "mesh_apply_wide": "src/repro/kernels/mesh_apply.py:45",
            "ptc_block_matmul_wide_tc":
                "src/repro/kernels/ptc_block_matmul.py:46",
            "sigma_grad_wide_tc": "src/repro/kernels/sigma_grad.py:43",
            "feedback_matmul_wide_tc":
                "src/repro/kernels/feedback_matmul.py:48",
            "ptc_block_matmul_wide_3xtf32":
                "src/repro/kernels/ptc_block_matmul.py:46",
            "sigma_grad_wide_3xtf32": "src/repro/kernels/sigma_grad.py:43",
            "feedback_matmul_wide_3xtf32":
                "src/repro/kernels/feedback_matmul.py:48",
            "mesh_apply_wide_unrolled": "src/repro/kernels/mesh_apply.py:45"}
# the port's kernels by their device function names (a wrapper may launch
# several), for the profiles' per-kernel sums
KERNEL_FAMILIES = {
    "ptc_block_matmul": r"ptc_(compose|product|sum_splits)_kernel",
    "ptc_block_matmul_perblock": r"ptc_perblock_kernel",
    "sigma_grad": r"sigma_(grad|sum_splits)_kernel",
    "feedback_matmul": r"::(compose|transpose|feedback_matmul)_kernel",
    "mesh_apply": r"mesh_apply\w*_kernel",
}
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 without tensor
# cores, dense bf16 on the tensor cores (bf16 in, fp32 accumulate: the
# least-time route for attention's products), dense TF32 on the tensor
# cores (a 3xTF32 product takes three passes: 495 / 3 TFLOP/s of fp32
# work), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
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
    """Mean device ms per call over ``reps`` back-to-back calls (warm).

    A spin kernel holds the card while the host queues every call, so the
    events time the device alone even where a call's host work (a Python
    wrapper's checks) outlasts its kernels."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * reps * host_s + 1e-3)))  # ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split(fn, reps: int = 10) -> list[tuple[str, float]]:
    """(kernel name, device ms per call) of each kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key),
             e.self_device_time_total / reps / 1e3)
            for e in prof.key_averages() if e.self_device_time_total]


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def ls_scale(got, want) -> float:
    """The least-squares scale of ``got`` against ``want`` (1 when ``got``
    carries no bias; a column scale rounded to bf16 read 1.0020-1.0024)."""
    g, w = got.double().flatten(), want.double().flatten()
    if float(w @ w) == 0.0:             # every column masked: zeros
        return 1.0 if float(g @ g) == 0.0 else float("inf")
    return float(g @ w / (w @ w))


def rel_err(a, b) -> tuple[float, float]:
    """(max abs error, max abs error over the largest |b|)."""
    diff = float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
    scale = float(b.float().abs().max()) if b.numel() else 0.0
    return diff, diff / (scale + 1e-6)


def ptxas_summary(log: str) -> list[str]:
    """One entry per kernel instantiation: its name, integer template
    argument, dtype (bf16 if any operand is), registers and (if any)
    spilled bytes, from ``nvcc -Xptxas -v``."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
            spill = ""
        elif int(re.search(r"(\d+) bytes spill stores", line).group(1)
                 if "spill stores" in line else 0):
            spill = ", spills: " + line.strip()
        elif "Used" in line and "registers" in line and name:
            base = re.search(r"\d+([a-z_]+_kernel)", name)
            width = re.search(r"Li(\d+)E", name)
            dtype = "bf16" if "bfloat16" in name else "fp32"
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{base.group(1) if base else name}"
                       f"<{width.group(1) if width else ''}> {dtype} "
                       f"{regs} regs{spill}")
            name = ""
    return out


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, parent=None, building=None) -> dict:
    """Phase 1; ``building``: a future of ``build.build(force=True)``
    already started, else the build runs here."""
    from repro_torch.core import unitary as un
    from repro_torch.kernels import build, mesh_apply, mesh_apply_plain
    from repro_torch.kernels.mesh_apply import mesh_apply_batched

    info = building.result() if building is not None \
        else build.build(force=True)
    print(f"[build] nvcc sm_90a, {len(info['built'])} kernels in parallel: "
          f"{info['seconds']:.1f} s")
    for name in build.SOURCES:
        print(f"[build] {name} ptxas: " + " | ".join(ptxas_summary(
            (build.BUILD_DIR / f"{name}.ptxas.log").read_text())))

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    summary = {}

    # -- ptc_block_matmul: both routes ---------------------------------------
    summary.update(ptc_kernels(torch, gen, parent))

    # -- mesh_apply ----------------------------------------------------------
    worst = 0.0
    before = build.launch_counts["mesh_apply"]
    n_calls = 0
    for k in (2, 4, 8, 9, 12, 13, 16, 24, 32):
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
                # 1000 rows transposed: row groups whose outputs are not
                # contiguous, stored from registers
                yt = mesh_apply_batched(spec, ph[None], x[None], d[None],
                                        transpose_out=True)
                worst = max(worst, float((yt - mesh_apply_plain(
                    spec, ph[None], x[None], d[None], transpose_out=True))
                    .abs().max()))
                n_calls += 2
            # block-batched, as build_unitary drives it
            b = 37
            phb = torch.randn(b, spec.n_rot, generator=gen, device=dev) * 3
            db = torch.where(torch.rand(b, k, generator=gen, device=dev)
                             < 0.5, 1.0, -1.0)
            u = un.build_unitary(spec, phb, db)
            ur = mesh_apply_plain(spec, phb, torch.eye(k, device=dev)[None],
                                  db, transpose_out=True)
            worst = max(worst, float((u - ur).abs().max()))
            # rows of their own per mesh, no signs
            xb = torch.randn(b, 3, k, generator=gen, device=dev)
            worst = max(worst, float((mesh_apply_batched(spec, phb, xb)
                                      - mesh_apply_plain(spec, phb, xb))
                                     .abs().max()))
            n_calls += 2
    torch.cuda.synchronize()
    check(worst < 1e-5, f"mesh_apply: max abs err {worst:.2e} >= 1e-5")
    check(build.launch_counts["mesh_apply"] - before == n_calls,
          "mesh_apply: a k <= 32 call did not take the narrow route")

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
    print(f"[check] mesh_apply: k in 2,4,8,9,12,13,16,24,32 x clements,reck, "
          f"24 and 1000 rows (both output layouts), batched (identity and rows "
          f"of their own); full width {nb} meshes x 9 rows: max abs err "
          f"{worst:.2e} (tol 1e-5)")
    del ur
    # build_unitary's call on one identity made outside the timing
    ms = cuda_ms(lambda: mesh_apply_batched(spec, phb, eye, db,
                                            transpose_out=True), 50)
    plain = cuda_ms(lambda: mesh_apply_plain(spec, phb, eye, db,
                                             transpose_out=True), 5)
    t_rot = spec.n_rot
    # per mesh: one sincos (counted as 2 operations) per phase, 6 per
    # rotation per row, one sign multiply per wire per row
    flops = nb * (2 * t_rot + k * (6 * t_rot + k))
    nbytes = 4 * (nb * t_rot + nb * k + k * k + nb * k * k)
    b_ms, b_by = bound_ms(flops, nbytes)
    print(f"[time] mesh_apply build_unitary ({nb} meshes x {k} rows, k={k}, "
          f"clements): kernel {ms:.4f} ms ({100 * b_ms / ms:.0f}% of the "
          f"bound), plain {plain:.4f} ms, no one-call yardstick, bound "
          f"{b_ms:.4f} ms ({b_by})")
    summary["mesh_apply"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain,
                                 library_ms=None, bound_ms=b_ms,
                                 bound_by=b_by)
    summary.update(backward_kernels(torch, gen, parent))
    summary.update(wide_kernels(torch, gen))
    summary.update(serving_kernels(torch, gen, parent))
    return summary


def ptc_kernels(torch, gen, parent=None) -> dict:
    """``ptc_block_matmul`` on both routes against its plain version: the
    reference test sweep, ragged T, VGG-8's layer geometries at batch 32,
    T at each route's tile edge (fp32 and bf16; Q = 1 shapes on both
    routes); the launch rule and the kernel's tiles against the wrapper's
    plan; then both routes timed at their main paths' shapes."""
    import ctypes
    from repro_torch.core.ptc import PTCParams, compose_weight, unblockize
    from repro_torch.kernels import build, ptc_block_matmul, ref
    from repro_torch.kernels.ptc_block_matmul import (
        K_STAGE, LIB, PER_BLOCK_MAX_T, ROUTES, Plan, plan, route)

    dev = torch.device("cuda")
    sms = build.sm_count(dev)

    # the kernel's tile (rows, blocks, K stage) is the wrapper plan's
    out = (ctypes.c_int * 3)()
    for k in (4, 8, 9, 13, 16, 32):
        for p in (2, 8, 9, 57):
            pl = plan(64, p, 3, k, sms)
            want = (pl.bm, pl.nblk, K_STAGE)
            check(build.library(LIB).ptc_block_matmul_tile(k, pl.wn, out)
                  == 0 and tuple(out) == want,
                  f"ptc_block_matmul k={k} P={p}: the kernel's tile "
                  f"{tuple(out)} is not the plan's {want}")

    def ptc_inputs(t, p, q, k, dtype):
        def mk(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return mk(t, q * k), mk(p, q, k, k), mk(p, q, k), mk(p, q, k, k)

    narrow = ("product", "per_block")              # the k <= 32 routes
    worst = {r: [0.0, 0.0] for r in narrow}        # rel, abs (fp32)
    n_checked = {r: 0 for r in narrow}
    shapes = [(8, 2, 3, 8), (64, 4, 4, 16), (32, 1, 1, 9), (16, 3, 2, 4),
              (128, 2, 2, 32),                      # reference test sweep
              (1000, 3, 5, 9), (37, 2, 3, 13),      # ragged T
              (9, 25992, 1, 9),                     # IC / PM probe
              (1024, 2, 57, 9), (1024, 57, 456, 9),  # serve, W2 and W1
              # VGG-8 at batch 32: conv0 (Q·k 27), conv2 (P·k 135), conv4
              # (P·k 261), FC W1 (P·k 513), FC 512 -> 10 (Q·k 513)
              (32768, 8, 3, 9), (8192, 15, 64, 9), (2048, 29, 128, 9),
              (32, 57, 456, 9), (32, 2, 57, 9),
              # T at the product tiles' edges (128 rows for P > 8, 256 for
              # P <= 8) and the per-block route's (32-row stages, the
              # crossover at PER_BLOCK_MAX_T)
              (127, 9, 4, 9), (128, 9, 4, 9), (129, 9, 4, 9),
              (255, 8, 5, 9), (256, 8, 5, 9), (257, 8, 5, 9),
              (31, 300, 1, 9), (32, 300, 1, 9), (33, 300, 1, 9),
              (PER_BLOCK_MAX_T, 300, 1, 9), (PER_BLOCK_MAX_T + 1, 300, 1, 9),
              (9, 64, 1, 4), (9, 64, 1, 8), (13, 64, 1, 13), (16, 64, 1, 16),
              (32, 20, 1, 32),
              # k = 12 and 24 inside the k = 16 and 32 instances (the paper
              # tables' block sizes): both routes, the probes' Q = 1 too
              (12, 64, 1, 12), (24, 20, 1, 24), (128, 8, 8, 12),
              (300, 3, 5, 12), (128, 3, 3, 24), (129, 2, 5, 24)]
    for (t, p, q, k) in shapes:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
            if dtype == torch.bfloat16 and t * p * q > 1e6:
                continue
            x, u, s, v = ptc_inputs(t, p, q, k, dtype)
            yr = ref.ptc_block_matmul_ref(x, u, s, v)
            picked = route(t, p, q, k)
            for which in narrow if q == 1 else ("product",):
                before = dict(build.launch_counts)
                y = ptc_block_matmul(x, u, s, v, force_route=which)
                again = ptc_block_matmul(x, u, s, v, force_route=which)
                torch.cuda.synchronize()
                what = f"ptc_block_matmul {which} {(t, p, q, k)} {dtype}"
                check(build.launch_counts[ROUTES[which]]
                      - before[ROUTES[which]] == 2,
                      f"{what}: not launched on its route")
                diff, rel = rel_err(y, yr)
                check(y.shape == yr.shape and bool(torch.isfinite(y).all()),
                      f"{what}: bad output")
                check(rel < tol, f"{what}: rel err {rel:.2e} >= {tol}")
                check(torch.equal(y, again), f"{what}: two runs differ")
                n_checked[which] += 1
                if dtype == torch.float32:
                    worst[which] = [max(worst[which][0], rel),
                                    max(worst[which][1], diff)]
            before = dict(build.launch_counts)
            ptc_block_matmul(x, u, s, v)
            check(build.launch_counts[ROUTES[picked]]
                  == before[ROUTES[picked]] + 1,
                  f"ptc_block_matmul {(t, p, q, k)}: the call did not take "
                  f"the {picked} route its rule names")
    # the split-K plans rerun bitwise (FC W1 at batch 32 splits 33 ways)
    x, u, s, v = ptc_inputs(32, 57, 456, 9, torch.float32)
    yr = ref.ptc_block_matmul_ref(x, u, s, v)
    ktiles = -(-456 * 9 // K_STAGE)
    for splits in (1, 2, 7, plan(32, 57, 456, 9, sms).splits, ktiles):
        pl = plan(32, 57, 456, 9, sms)
        kt = -(-ktiles // splits)
        pl = Plan(pl.kt, pl.wn, pl.bm, pl.nblk, -(-ktiles // kt),
                  K_STAGE * kt)
        y = ptc_block_matmul(x, u, s, v, force_plan=pl)
        check(torch.equal(y, ptc_block_matmul(x, u, s, v, force_plan=pl))
              and rel_err(y, yr)[1] < 1e-4,
              f"ptc_block_matmul FC W1 at T 32, {pl.splits} K splits: wrong "
              f"or not deterministic")
    for which in narrow:
        print(f"[check] ptc_block_matmul {which} route ({ROUTES[which]}): "
              f"{n_checked[which]} cases (fp32 + bf16), deterministic, max "
              f"rel err {worst[which][0]:.2e} (tol 1e-4 fp32, 6e-2 bf16), "
              f"max abs err {worst[which][1]:.2e}; the rule picks per_block "
              f"for Q = 1 and T <= {PER_BLOCK_MAX_T}, product otherwise")

    old = parent_ptc(torch, parent)
    summary, timings = {}, {}
    for label, (t, p, q, k), reps in (
            ("serve W1", (1024, 57, 456, 9), 20),
            ("probe", (9, 25992, 1, 9), 50),
            ("conv l1", (32768, 8, 64, 9), 20),
            ("FC W1 at T 32", (32, 57, 456, 9), 50)):
        x, u, s, v = ptc_inputs(t, p, q, k, torch.float32)
        which = route(t, p, q, k)
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
                              bound_ms=b_ms, bound_by=b_by, route=which)
        extra = ""
        if old is not None:
            extra = (f", the parent tree's kernel "
                     f"{cuda_ms(lambda: old(x, u, s, v), reps):.4f} ms")
        split = device_split(lambda: ptc_block_matmul(x, u, s, v))
        pl = plan(t, p, q, k, sms)
        print(f"[time] ptc_block_matmul {label} (T={t}, P={p}, Q={q}, k={k},"
              f" fp32), {which} route"
              + (f" ({pl.bm} rows x {pl.nblk} blocks a CTA, {pl.splits} K "
                 f"splits)" if which == "product" else "")
              + f": kernel {ms:.4f} ms ({100 * b_ms / ms:.0f}% of the bound;"
              f" by launch " + ", ".join(f"{n} {m:.4f}" for n, m in split)
              + f"){extra}, plain {plain:.4f} ms, library x @ "
              f"unblockize(compose_weight).T {lib:.4f} ms, bound {b_ms:.4f} "
              f"ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    # the crossover: both routes at Q = 1, over the probe's 25,992 blocks
    # and over 57 (the per-block grid spans P alone)
    for p in (25992, 57):
        line = []
        for t in (9, 32, 64, 128, 256, 1024):
            x, u, s, v = ptc_inputs(t, p, 1, 9, torch.float32)
            by_route = {r: cuda_ms(lambda: ptc_block_matmul(
                x, u, s, v, force_route=r), 20) for r in narrow}
            line.append(f"T {t}: " + ", ".join(
                f"{r} {m:.4f}" for r, m in by_route.items()))
        print(f"[time] ptc_block_matmul at Q = 1, P = {p}, k = 9, ms by "
              f"route: " + "; ".join(line))
    # what x's 4-byte copies cost: serve W1 with x 16-byte aligned and not
    x, u, s, v = ptc_inputs(1024, 57, 456, 9, torch.float32)
    buf = torch.empty(x.numel() + 1, device=dev)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    print(f"[time] ptc_block_matmul serve W1, x by 16-byte copies "
          f"{cuda_ms(lambda: ptc_block_matmul(x, u, s, v), 20):.4f} ms, by "
          f"4-byte copies (x 4 bytes off alignment) "
          f"{cuda_ms(lambda: ptc_block_matmul(xm, u, s, v), 20):.4f} ms")
    for which, label in (("product", "serve W1"), ("per_block", "probe")):
        info = dict(timings[label])
        del info["route"]
        summary[ROUTES[which]] = dict(max_abs_err=worst[which][1], **info)
    return summary


def parent_library(torch, parent, name, marker):
    """An earlier tree's ``csrc/<name>.cu`` built into ``build/parent/``
    and loaded, or None without a parent tree or where that source lacks
    ``marker``, a piece of the C interface the caller knows how to call
    (elsewhere the kernel was not redesigned since)."""
    import ctypes
    import os
    from repro_torch.kernels import build
    if parent is None:
        return None
    src = Path(parent) / "src" / "repro_torch" / "csrc" / f"{name}.cu"
    if marker not in src.read_text():
        print(f"[build] the parent tree's {name}.cu has this tree's "
              f"interface (not redesigned since): not timed")
        return None
    out = build.BUILD_DIR.parent / "parent" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True)
    check(res.returncode == 0, f"parent {name}: nvcc failed:\n{res.stdout}"
                               f"{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    print(f"[build] parent tree's {name}.cu ({os.path.relpath(src)}): built")
    return lib


def parent_ptc(torch, parent):
    """The earlier tree's ``ptc_block_matmul`` (its C interface: one
    kernel, ``(x, u, s, v, y, T, P, Q, k, dtype, stream)``) as a callable
    on fp32 inputs, or None."""
    import ctypes
    lib = parent_library(torch, parent, "ptc_block_matmul",
                         "int ptc_block_matmul(")
    if lib is None:
        return None
    fn = lib.ptc_block_matmul
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]

    def call(x, u, s, v):
        p, q, k, _ = u.shape
        y = torch.empty((x.shape[0], p * k), device=x.device)
        status = fn(x.data_ptr(), u.data_ptr(), s.data_ptr(), v.data_ptr(),
                    y.data_ptr(), x.shape[0], p, q, k, 0,
                    torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"parent ptc_block_matmul: CUDA error {status}")
        return y
    return call


def parent_sigma(torch, parent):
    """The earlier tree's ``sigma_grad`` (its C interface: the row chunks
    from ``sigma_grad_chunks``) as a callable, or None."""
    import ctypes
    lib = parent_library(torch, parent, "sigma_grad",
                         "int sigma_grad_chunks(")
    if lib is None:
        return None
    lib.sigma_grad.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.sigma_grad_chunks.argtypes = [ctypes.c_int] * 4

    def call(dy, x, u, v):
        p, q, k, _ = u.shape
        t = dy.shape[0]
        chunks = lib.sigma_grad_chunks(t, p, q, k)
        part = torch.empty((chunks, p, q, k) if chunks > 1 else (0,),
                           device=dy.device)
        ds = torch.empty((p, q, k), device=dy.device)
        status = lib.sigma_grad(dy.data_ptr(), x.data_ptr(), u.data_ptr(),
                                v.data_ptr(), part.data_ptr(), ds.data_ptr(),
                                t, p, q, k, chunks,
                                torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"parent sigma_grad: CUDA error {status}")
        return ds
    return call


def backward_kernels(torch, gen, parent=None) -> dict:
    """``sigma_grad`` and ``feedback_matmul`` against their plain versions,
    then timed at the training path's full-width shapes."""
    from repro_torch.core.ptc import (PTCParams, blockize, compose_weight,
                                      unblockize)
    from repro_torch.core.sparsity import SparsityConfig, feedback_mask
    from repro_torch.kernels import build, feedback_matmul, ref, sigma_grad
    from repro_torch.kernels.sigma_grad import Plan as SigmaPlan
    from repro_torch.kernels.sigma_grad import plan as sigma_plan

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
              (32768, 8, 64, 9), (32768, 8, 3, 9),   # VGG-8 conv l1, l0
              # the paper tables' k = 12 and 24 (padded instances)
              (128, 8, 8, 12), (37, 3, 5, 12), (128, 3, 3, 24),
              (300, 2, 5, 24)]
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
            check(torch.equal(dx, feedback_matmul(dy, u, s, v, mask)),
                  f"feedback_matmul {(t, p, q, k)} {label}: two runs differ")
            if label == "density 0.0":
                check(int(torch.count_nonzero(dx)) == 0,
                      f"feedback_matmul {(t, p, q, k)}: density 0 is not an "
                      f"exact zero")
        torch.cuda.synchronize()
    # sigma_grad alone: VGG-8's other layer geometries at batch 32, T at
    # the ring stage's edge (16 rows) and at a split plan's chunk edge, and
    # the split-T plans rerun bitwise
    extra = [(8192, 15, 64, 9), (2048, 29, 128, 9), (32, 57, 456, 9),
             (32, 2, 57, 9), (15, 3, 17, 9), (16, 3, 17, 9), (17, 3, 17, 9),
             (255, 9, 3, 9), (256, 9, 3, 9), (257, 9, 3, 9),
             (300, 5, 7, 4), (300, 5, 7, 8), (300, 5, 7, 13), (300, 3, 5, 16),
             (300, 3, 5, 32)]
    for (t, p, q, k) in extra:
        dy, x, u, v = mk(t, p * k), mk(t, q * k), mk(p, q, k, k), \
            mk(p, q, k, k)
        ds = sigma_grad(dy, x, u, v)
        record("sigma_grad", (t, p, q, k), ds, ref.sigma_grad_ref(dy, x, u, v))
        check(torch.equal(ds, sigma_grad(dy, x, u, v)),
              f"sigma_grad {(t, p, q, k)}: two runs differ")
    dy, x, u, v = mk(4096, 8 * 9), mk(4096, 64 * 9), mk(8, 64, 9, 9), \
        mk(8, 64, 9, 9)
    want = ref.sigma_grad_ref(dy, x, u, v)
    for chunk in (16, 272, 1024, 4096):
        pl = SigmaPlan(9, 8, 16, -(-4096 // chunk), chunk)
        ds = sigma_grad(dy, x, u, v, force_plan=pl)
        record("sigma_grad", f"(4096, 8, 64, 9), {pl.splits} T splits", ds,
               want)
        check(torch.equal(ds, sigma_grad(dy, x, u, v, force_plan=pl)),
              f"sigma_grad {pl.splits} T splits: two runs differ")
    torch.cuda.synchronize()
    for name, (rel, diff) in worst.items():
        print(f"[check] {name}: {len(shapes)} shapes"
              + (f" + {len(extra)} + 4 split plans" if name == "sigma_grad"
                 else "")
              + (" x masks of density 0, 0.5, 1 and btopk 0.6 (density 0 "
                 "an exact zero), deterministic"
                 if name == "feedback_matmul" else ", deterministic")
              + f", max rel err {rel:.2e} (tol 1e-4), max abs err "
                f"{diff:.2e}")

    timings = {}
    old = parent_sigma(torch, parent)
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
        pl = sigma_plan(t, p, q, k, build.sm_count(dev))
        split = device_split(lambda: sigma_grad(dy, x, u, v))
        par = "" if old is None else (
            f", the parent tree's kernel "
            f"{cuda_ms(lambda: old(dy, x, u, v), 20):.4f} ms")
        print(f"[time] sigma_grad {label} (T={t}, P={p}, Q={q}, k={k}, "
              f"fp32; {pl.mp} x {pl.nq} blocks a CTA, {pl.splits} T splits):"
              f" kernel {ms:.4f} ms ({100 * b_ms / ms:.0f}% of the bound; by "
              f"launch " + ", ".join(f"{n} {m:.4f}" for n, m in split)
              + f"){par}, plain {plain:.4f} ms, library "
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
        split = device_split(lambda: feedback_matmul(dy, u, s, v, mask))
        print(f"[time] feedback_matmul {label} (T={t}, P={p}, Q={q}, k={k}, "
              f"btopk 0.6: {kept} of {p * q} blocks, fp32): kernel "
              f"{ms:.4f} ms ({100 * b_ms / ms:.0f}% of the bound; by launch "
              + ", ".join(f"{n} {m:.4f}" for n, m in split)
              + f"), plain {plain:.4f} ms, yardstick dy @ masked "
              f"unblockize(W) (one cuBLAS call) {lib:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
    return {name: dict(max_abs_err=worst[name][1],
                       **timings[(name, "FC W1")])
            for name in ("sigma_grad", "feedback_matmul")}


# olmo-1b's PTC linears at full width (src/repro_torch/configs/olmo_1b.py:
# d_model 2048, d_ff 8192; k = 128): (name, d_in, d_out)
OLMO_LINEARS = (("q", 2048, 2048), ("k", 2048, 2048), ("v", 2048, 2048),
                ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
                ("down", 8192, 2048))
BLOCKED_LM_T = 4096     # one train_4k sequence (src/repro/configs/common.py:53)
WIDE_KERNELS = ("ptc_block_matmul_wide", "sigma_grad_wide",
                "feedback_matmul_wide")
# the 3xTF32 routes of the three PTC kernels (fp32 at k 64 and 128): the
# blocked LM's fp32 step takes these
TF32X3_KERNELS = ("ptc_block_matmul_wide_3xtf32", "sigma_grad_wide_3xtf32",
                  "feedback_matmul_wide_3xtf32")
# the tensor-core routes of the three PTC kernels (bf16 at k 64 and 128):
# the blocked LM's bf16 step takes these
TC_KERNELS = ("ptc_block_matmul_wide_tc", "sigma_grad_wide_tc",
              "feedback_matmul_wide_tc")
NARROW_PTC = ("ptc_block_matmul", "ptc_block_matmul_perblock", "sigma_grad",
              "feedback_matmul")


def wide_kernels(torch, gen) -> dict:
    """The k > 32 routes of the three PTC kernels and of ``mesh_apply``
    against their plain versions (k 33, 64, 100, 128; fp32 and bf16; T at
    the 128-row tile's edges and 4096; feedback masks of density 0, 0.5, 1
    and btopk, and btopk with a q row masked everywhere; reruns bitwise;
    meshes with and without signs), then each timed at olmo-1b's up
    projection (2048 → 8192, T 4096; bf16 operands, and fp32 ones for the
    3xTF32 routes and the CUDA-core routes timed in turns with them) and
    at 2,048 reck meshes of k = 128 (the unrolled route in turns with the
    list-driven one)."""
    import ctypes
    from repro_torch.core import unitary as un
    from repro_torch.core.ptc import PTCParams, compose_weight, unblockize
    from repro_torch.core.sparsity import (SparsityConfig, column_mask,
                                           feedback_mask)
    from repro_torch.kernels import (build, feedback_matmul, mesh_apply_plain,
                                     ptc_block_matmul, ref, sigma_grad)
    from repro_torch.kernels.mesh_apply import mesh_apply_batched
    from repro_torch.kernels.ptc_block_matmul import (TC_K, TC_TILE,
                                                      TF32X3_TILE, WIDE_TILE,
                                                      tc_lib, tf32x3_lib,
                                                      wide_lib)

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    out = (ctypes.c_int * 3)()
    check(wide_lib().ptc_wide_tile(out) == 0 and tuple(out) == WIDE_TILE,
          f"ptc_wide: the kernel's tile {tuple(out)} is not the plan's "
          f"{WIDE_TILE}")
    check(tc_lib().ptc_tc_tile(out) == 0 and tuple(out) == TC_TILE,
          f"ptc_wide_tc: the kernel's tile {tuple(out)} is not the plan's "
          f"{TC_TILE}")
    check(tf32x3_lib().ptc_3xtf32_tile(out) == 0
          and tuple(out) == TF32X3_TILE,
          f"ptc_wide_3xtf32: the kernel's tile {tuple(out)} is not the "
          f"plan's {TF32X3_TILE}")
    # the k <= 32 Σ-gradient's tile (p-blocks, q-blocks, rows a stage),
    # through the wrapper's own binding of sigma_grad_tile
    from repro_torch.kernels.sigma_grad import _BK, _TILE, _lib as sigma_lib
    for k in (4, 8, 9, 16, 32):
        check(sigma_lib().sigma_grad_tile(k, out) == 0
              and tuple(out) == (*_TILE[k], _BK),
              f"sigma_grad k={k}: the kernel's tile {tuple(out)} is not the "
              f"plan's {(*_TILE[k], _BK)}")
    print("[check] sigma_grad_tile (bound in the wrapper): the kernel's "
          "tile is the plan's at k = 4, 8, 9, 16, 32")

    def mk(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def masks(q, p):
        for dens in (0.0, 0.5, 1.0):
            keep = torch.rand((q, p), generator=gen, device=dev) < dens
            yield f"density {dens}", keep.float() * 2.0
        yield "btopk 0.6", feedback_mask(
            gen, torch.rand((p, q), generator=gen, device=dev),
            SparsityConfig(alpha_w=0.6, feedback_mode="btopk"))

    # fp32: 1e-4 of the largest entry (sums in another order); bf16
    # outputs (y, dx) are rounded to bf16 on both sides, so two fp32 sums
    # that agree to 1e-6 may round one bf16 ulp apart: 2^-7 of the largest
    # entry; ds is fp32 whatever the operands
    # bf16 at k 64 and 128 takes the tensor cores (y from U diag(s) and W
    # each rounded once to bf16: still one bf16 ulp of y, 2^-7; ds at 1e-4
    # with col ⊙ δy split into bf16 hi + lo), fp32 there the forward and
    # the Σ-gradient and the feedback in 3xTF32 (y, ds and dx at 1e-5:
    # about fp32's own sums), every other case the CUDA cores; the
    # least-squares scale of every column-scaled ds within 5e-4 of 1
    sweep = WIDE_KERNELS + TC_KERNELS + TF32X3_KERNELS
    worst = {n: [0.0, 0.0] for n in sweep}      # rel, abs
    n_cases = dict.fromkeys(sweep, 0)
    worst_scale = 0.0

    def record(name, what, got, want, tol):
        diff, rel = rel_err(got, want)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        check(rel < tol, f"{name} {what}: rel err {rel:.2e} >= {tol}")
        worst[name] = [max(worst[name][0], rel), max(worst[name][1], diff)]
        n_cases[name] += 1

    before = dict(build.launch_counts)
    for (t, p, q, k) in ((37, 2, 3, 33), (64, 2, 2, 64), (129, 3, 2, 100),
                         (127, 3, 3, 128), (128, 2, 3, 128), (129, 3, 2, 128),
                         (1, 1, 1, 128), (300, 1, 2, 128), (300, 3, 5, 64),
                         (257, 4, 3, 128), (1, 3, 3, 64), (127, 2, 3, 64),
                         (128, 3, 2, 64), (129, 5, 3, 64), (4096, 3, 5, 64),
                         (4096, 5, 3, 128)):
        for dtype in (f32, bf16):
            tol = 1e-4 if dtype == f32 else 2 ** -7
            x, dy = mk(t, q * k, dtype=dtype), mk(t, p * k, dtype=dtype)
            u, s, v = mk(p, q, k, k, dtype=dtype), mk(p, q, k, dtype=dtype), \
                mk(p, q, k, k, dtype=dtype)
            what = f"{(t, p, q, k)} {dtype}"
            tc = "_tc" if dtype == bf16 and k in TC_K else ""
            x3 = dtype == f32 and k in TC_K
            fwd = "ptc_block_matmul_wide" + tc + ("_3xtf32" if x3 else "")
            sig = "sigma_grad_wide" + tc + ("_3xtf32" if x3 else "")
            tol_fs = 1e-5 if x3 else tol        # the forward's y
            tol_ds = 1e-5 if x3 else 1e-4
            y = ptc_block_matmul(x, u, s, v)
            record(fwd, what, y, ref.ptc_block_matmul_ref(x, u, s, v), tol_fs)
            check(torch.equal(y, ptc_block_matmul(x, u, s, v)),
                  f"{fwd} {what}: two runs differ")
            ds = sigma_grad(dy, x, u, v)
            record(sig, what, ds, ref.sigma_grad_ref(dy, x, u, v), tol_ds)
            check(torch.equal(ds, sigma_grad(dy, x, u, v)),
                  f"{sig} {what}: two runs differ")
            # a column scale off bf16's grid, applied in fp32
            col = (torch.rand((t,), generator=gen, device=dev) < 0.6) \
                .float() / 0.6
            ds = sigma_grad(dy, x, u, v, col)
            want = ref.sigma_grad_ref(dy, x, u, v, col)
            record(sig, f"{what} col", ds, want, tol_ds)
            check(torch.equal(ds, sigma_grad(dy, x, u, v, col)),
                  f"{sig} {what} col: two runs differ")
            scale = ls_scale(ds, want)
            check(abs(scale - 1) < 5e-4, f"{sig} {what} col: least-squares "
                                         f"scale {scale:.6f}")
            worst_scale = max(worst_scale, abs(scale - 1))
            fb = "feedback_matmul_wide" + tc + ("_3xtf32" if x3 else "")
            tol_dx = 1e-5 if x3 else tol
            for label, mask in masks(q, p):
                dx = feedback_matmul(dy, u, s, v, mask)
                want = ref.feedback_matmul_ref(dy, u, s, v, mask)
                record(fb, f"{what} {label}", dx, want, tol_dx)
                check(torch.equal(dx, feedback_matmul(dy, u, s, v, mask)),
                      f"{fb} {what} {label}: two runs differ")
                if label == "density 0.0":
                    check(int(torch.count_nonzero(dx)) == 0,
                          f"{fb} {what}: density 0 is not an exact zero")
                if label.startswith("btopk"):   # the last q row masked
                    mask = mask.clone()
                    mask[q - 1] = 0.0
                    dx = feedback_matmul(dy, u, s, v, mask)
                    want = ref.feedback_matmul_ref(dy, u, s, v, mask)
                    record(fb, f"{what} {label}, q row {q - 1} masked", dx,
                           want, tol_dx)
                    check(torch.equal(dx, feedback_matmul(dy, u, s, v,
                                                          mask)),
                          f"{fb} {what} masked row: two runs differ")
                    check(int(torch.count_nonzero(dx[:, (q - 1) * k:])) == 0,
                          f"{fb} {what}: a q row masked everywhere is not "
                          f"an exact zero")
    torch.cuda.synchronize()
    for name in sweep:
        check(build.launch_counts[name] - before[name] == 2 * n_cases[name],
              f"{name}: not every call took the route its rule names")
    check(all(build.launch_counts[n] == before[n] for n in NARROW_PTC),
          "a k > 32 call took a k <= 32 route")
    print(f"[check] wide PTC routes, k 33/64/100/128, fp32 + bf16, T at "
          f"the 128-row tile's edges: " + ", ".join(
              f"{n} {n_cases[n]} cases, max rel err {worst[n][0]:.2e}"
              for n in sweep)
          + " (tol 1e-4 fp32 and ds; 2^-7 for bf16 y and dx: one bf16 "
            "rounding; 1e-5 for the 3xTF32 y, ds and dx; bf16 at k 64 and "
            "128 on the tensor cores, fp32 there in 3xTF32, the rest on the "
            "CUDA cores); ds also under a column scale of 1/0.6 "
            f"(fp32; least-squares scale within {worst_scale:.1e} of 1, tol "
            "5e-4); feedback masks of density 0, 0.5, 1 and btopk 0.6, and "
            "btopk with the last q row masked (density 0 and the masked row "
            "exact zeros); reruns bitwise")

    # mesh_apply's wide routes: build_unitary (the shared identity, output
    # transposed) and rows of their own, both mesh kinds; k 64 and 128 on
    # the unrolled route, also without signs, 33 and 100 on the
    # list-driven one
    mesh_names = ("mesh_apply_wide", "mesh_apply_wide_unrolled")
    mesh_worst = dict.fromkeys(mesh_names, 0.0)
    mesh_before = {n: build.launch_counts[n] for n in mesh_names}
    orth = 0.0
    for k in (33, 64, 100, 128):
        name = mesh_names[k in (64, 128)]
        for kind in ("reck", "clements"):
            spec = un.mesh_spec(k, kind)
            ph = mk(37, spec.n_rot) * 3
            eye = torch.eye(k, device=dev)[None]
            signs = (torch.where(mk(37, k) < 0, -1.0, 1.0), None)
            for d in signs[:1 + (name == "mesh_apply_wide_unrolled")]:
                uu = un.build_unitary(spec, ph, d)
                err = float((uu - mesh_apply_plain(
                    spec, ph, eye, d, transpose_out=True)).abs().max())
                orth = max(orth, float((uu @ uu.transpose(1, 2) - eye)
                                       .abs().max()))
                xr = mk(37, 70, k)
                err = max(err, float((mesh_apply_batched(spec, ph, xr, d)
                                      - mesh_apply_plain(spec, ph, xr, d))
                                     .abs().max()))
                mesh_worst[name] = max(mesh_worst[name], err)
    torch.cuda.synchronize()
    for name in mesh_names:
        check(mesh_worst[name] < 1e-5, f"{name}: max abs err "
                                       f"{mesh_worst[name]:.2e} >= 1e-5")
    check(orth < 1e-4, f"mesh_apply wide routes: U U^T - I {orth:.2e}")
    check({n: build.launch_counts[n] - mesh_before[n] for n in mesh_names}
          == {"mesh_apply_wide": 8, "mesh_apply_wide_unrolled": 16},
          "mesh_apply: a k > 32 call did not take the wide route its rule "
          "names")

    summary = {}
    # olmo-1b's up projection, bf16 operands as the blocked LM passes them;
    # the same values widened to fp32 for the fp32 step's routes
    t, p, q, k = BLOCKED_LM_T, 64, 16, 128
    x, dy = mk(t, q * k, dtype=bf16), mk(t, p * k, dtype=bf16)
    u, s, v = mk(p, q, k, k, dtype=bf16), mk(p, q, k, dtype=bf16), \
        mk(p, q, k, k, dtype=bf16)
    mask = feedback_mask(gen, torch.rand((p, q), generator=gen, device=dev),
                         SparsityConfig(alpha_w=0.6))
    # a column scale off bf16's grid (column_norm "exp": 1/0.6)
    col = column_mask(gen, t, SparsityConfig(alpha_c=0.6,
                                             column_norm="exp"))
    kept = int(torch.count_nonzero(mask))
    x32, dy32, dyc32 = x.float(), dy.float(), dy.float() * col[:, None]
    u32, s32, v32 = u.float(), s.float(), v.float()
    w32 = unblockize(compose_weight(PTCParams(u32, s32, v32)))
    wm32 = unblockize(compose_weight(PTCParams(u32, s32, v32))
                      * mask.T[:, :, None, None])
    w16 = w32.to(bf16)                  # composed and rounded outside
    wm16 = wm32.to(bf16)
    fwd_flops = 2 * k * k * t * p * q + (2 * k ** 3 + k * k) * p * q
    sig_flops = 2 * k * k * t * p * q + (2 * k ** 3 + 2 * k * k) * p * q

    def op_bytes(eb, *ts, out=0, out_eb=4):
        """bytes of the operands ``ts`` at ``eb`` bytes an element, and of
        ``out`` outputs or column scales at ``out_eb``"""
        return eb * sum(a.numel() for a in ts) + out_eb * out

    def sig_lib(d32):
        return lambda: torch.einsum("tpi,tqj,pqik,pqkj->pqk",
                                    d32.view(t, p, k), x32.view(t, q, k),
                                    u32, v32)

    def tf32_call(fn):
        """fn with cuBLAS's one-pass TF32 products allowed, and the setting
        restored after each call"""
        def call():
            before = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return fn()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = before
        return call

    fb_flops = kept * (2 * k * k * t + 2 * k ** 3 + k * k)
    # dy, the kept blocks' U, s and V*, dx at eb bytes; the fp32 mask
    fb_bytes = {eb: eb * (dy.numel() + kept * (2 * k * k + k) + t * q * k)
                + 4 * mask.numel() for eb in (2, 4)}
    fb_lib = (lambda: dy32 @ wm32, "fp32 dy @ masked composed unblockize(W)")
    fb_b16 = (lambda: dy @ wm16, "bf16 dy @ masked composed W")
    fb_tf32 = (tf32_call(lambda: dy32 @ wm32), "one-pass TF32 dy @ W~")
    fwd_lib = (lambda: x32 @ w32.T, "fp32 x @ composed unblockize(W).T")
    fwd_b16 = (lambda: x @ w16.T, "bf16 x @ composed W.T")
    fwd_tf32 = (tf32_call(lambda: x32 @ w32.T), "one-pass TF32 x @ W.T")
    sig_b16 = (lambda: dy.T @ x, "bf16 dy.T @ x (G alone)")
    sig_tf32 = (tf32_call(sig_lib(dy32)), "one-pass TF32 einsum")

    def fwd3():
        return ptc_block_matmul(x32, u32, s32, v32)

    def fwd_cc():
        return ptc_block_matmul(x32, u32, s32, v32, force_route="wide")

    def fwd32_plain():
        return ref.ptc_block_matmul_ref(x32, u32, s32, v32)

    def sig3():
        return sigma_grad(dy32, x32, u32, v32)

    def sig_cc():
        return sigma_grad(dy32, x32, u32, v32, force_route="wide")

    def sig32_plain():
        return ref.sigma_grad_ref(dy32, x32, u32, v32)

    def fb3():
        return feedback_matmul(dy32, u32, s32, v32, mask)

    def fb_cc():
        return feedback_matmul(dy32, u32, s32, v32, mask, force_route="wide")

    def fb32_plain():
        return ref.feedback_matmul_ref(dy32, u32, s32, v32, mask)

    # the fp32 routes in turns on the same inputs: 3xTF32, CUDA cores,
    # CUDA cores, 3xTF32 (each the lesser of its two readings)
    in_turns = {}
    for new, old in ((fwd3, fwd_cc), (sig3, sig_cc), (fb3, fb_cc)):
        times = [cuda_ms(f, 5) for f in (new, old, old, new)]
        in_turns[new] = (min(times[0], times[3]), (times[0], times[3]))
        in_turns[old] = (min(times[1], times[2]), (times[1], times[2]))
    # (summary name or None, label, kernel, plain, fp32 one-call yardstick,
    # second yardstick (bf16 or one-pass TF32) or None, flops, bytes, tol,
    # the rate the kernel's products run at): the tensor-core routes on
    # bf16 operands, the 3xTF32 routes on fp32 ones (3 TF32 passes: a third
    # of the TF32 peak), then the CUDA-core wide routes forced on the same
    # fp32 inputs
    x3_peak = PEAK_TF32_FLOPS / 3
    rows = (
        ("ptc_block_matmul_wide_tc", "ptc_block_matmul wide_tc (bf16)",
         lambda: ptc_block_matmul(x, u, s, v),
         lambda: ref.ptc_block_matmul_ref(x, u, s, v), fwd_lib, fwd_b16,
         fwd_flops, op_bytes(2, x, u, s, v, out=t * p * k, out_eb=2),
         2 ** -7, PEAK_BF16_FLOPS),
        ("ptc_block_matmul_wide_3xtf32",
         "ptc_block_matmul wide_3xtf32 (fp32)", fwd3, fwd32_plain, fwd_lib,
         fwd_tf32, fwd_flops, op_bytes(4, x32, u32, s32, v32, out=t * p * k),
         1e-5, x3_peak),
        ("ptc_block_matmul_wide", "ptc_block_matmul wide (forced, fp32)",
         fwd_cc, fwd32_plain, fwd_lib, fwd_tf32, fwd_flops,
         op_bytes(4, x32, u32, s32, v32, out=t * p * k), 1e-4,
         PEAK_FP32_FLOPS),
        ("sigma_grad_wide_tc", "sigma_grad wide_tc (bf16), col given (hi + "
         "lo)", lambda: sigma_grad(dy, x, u, v, col),
         lambda: ref.sigma_grad_ref(dy, x, u, v, col),
         (sig_lib(dyc32), "one fp32 einsum on col * dy"), sig_b16,
         sig_flops, op_bytes(2, dy, x, u, v, out=p * q * k + t), 1e-4,
         PEAK_BF16_FLOPS),
        (None, "sigma_grad wide_tc (bf16), col None",
         lambda: sigma_grad(dy, x, u, v),
         lambda: ref.sigma_grad_ref(dy, x, u, v),
         (sig_lib(dy32), "one fp32 einsum"), sig_b16, sig_flops,
         op_bytes(2, dy, x, u, v, out=p * q * k), 1e-4, PEAK_BF16_FLOPS),
        ("sigma_grad_wide_3xtf32", "sigma_grad wide_3xtf32 (fp32), col "
         "given (off bf16's grid)",
         lambda: sigma_grad(dy32, x32, u32, v32, col),
         lambda: ref.sigma_grad_ref(dy32, x32, u32, v32, col),
         (sig_lib(dyc32), "one fp32 einsum on col * dy"),
         (tf32_call(sig_lib(dyc32)), "one-pass TF32 einsum on col * dy"),
         sig_flops, op_bytes(4, dy32, x32, u32, v32, out=p * q * k + t),
         1e-5, x3_peak),
        (None, "sigma_grad wide_3xtf32 (fp32), col None", sig3, sig32_plain,
         (sig_lib(dy32), "one fp32 einsum"), sig_tf32, sig_flops,
         op_bytes(4, dy32, x32, u32, v32, out=p * q * k), 1e-5, x3_peak),
        ("sigma_grad_wide", "sigma_grad wide (forced, fp32), col None",
         sig_cc, sig32_plain, (sig_lib(dy32), "one fp32 einsum"), sig_tf32,
         sig_flops, op_bytes(4, dy32, x32, u32, v32, out=p * q * k), 1e-4,
         PEAK_FP32_FLOPS),
        ("feedback_matmul_wide_tc",
         f"feedback_matmul wide_tc (bf16), btopk 0.6: {kept} of {p * q} "
         f"blocks",
         lambda: feedback_matmul(dy, u, s, v, mask),
         lambda: ref.feedback_matmul_ref(dy, u, s, v, mask), fb_lib, fb_b16,
         fb_flops, fb_bytes[2], 2 ** -7, PEAK_BF16_FLOPS),
        ("feedback_matmul_wide_3xtf32",
         f"feedback_matmul wide_3xtf32 (fp32), btopk 0.6: {kept} of "
         f"{p * q} blocks", fb3, fb32_plain, fb_lib, fb_tf32, fb_flops,
         fb_bytes[4], 1e-5, x3_peak),
        ("feedback_matmul_wide",
         f"feedback_matmul wide (forced, fp32), btopk 0.6: {kept} of "
         f"{p * q} blocks", fb_cc, fb32_plain, fb_lib, fb_tf32, fb_flops,
         fb_bytes[4], 1e-4, PEAK_FP32_FLOPS),
    )
    peak_names = {PEAK_BF16_FLOPS: "bf16", x3_peak: "3 TF32 passes",
                  PEAK_FP32_FLOPS: "fp32 CUDA-core"}
    for (name, label, fn, plain_fn, (lib_fn, lib_what), alt, flops, nbytes,
         tol, peak) in rows:
        got, want = fn(), plain_fn()
        diff, rel = rel_err(got, want)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{label} olmo-1b up: bad output")
        check(rel < tol, f"{label} olmo-1b up: rel err {rel:.2e} >= {tol}")
        check(torch.equal(got, fn()), f"{label} olmo-1b up: two runs differ")
        extra = ""
        if "col given" in label:
            scale = ls_scale(got, want)
            check(abs(scale - 1) < 5e-4, f"{label} olmo-1b up: least-squares "
                                         f"scale {scale:.6f}")
            extra = f", least-squares scale {scale:.6f} (tol 5e-4)"
        _, lib_rel = rel_err(lib_fn(), want)
        alt_err = ""
        if alt is not None:
            alt_out = alt[0]()
            # the Σ-gradient's bf16 yardstick is G alone: no error to read
            if alt_out.shape == want.shape:
                alt_err = f" (rel err {rel_err(alt_out, want)[1]:.1e})"
            del alt_out
        del got, want
        if fn in in_turns:
            ms, turns = in_turns[fn]
            extra += f"; in turns {turns[0]:.4f}, {turns[1]:.4f}"
        else:
            ms = cuda_ms(fn, 20 if peak == PEAK_BF16_FLOPS else 5)
        plain = cuda_ms(plain_fn, 2)
        lib = cuda_ms(lib_fn, 5)
        alt_ms = cuda_ms(alt[0], 20) if alt is not None else None
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        b_x3, _ = bound_ms(flops, nbytes, x3_peak)
        split = device_split(fn, 3)
        print(f"[time] {label}, olmo-1b up projection (T={t}, P={p}, Q={q}, "
              f"k={k}): kernel {ms:.4f} ms ({100 * b_ms / ms:.1f}% of its "
              f"bound {b_ms:.4f} ms at the {peak_names[peak]} peak"
              + ("" if peak == x3_peak else
                 f"; {100 * b_x3 / ms:.1f}% of the 3xTF32 bound "
                 f"{b_x3:.4f} ms")
              + "; by launch " + ", ".join(f"{n} {m:.4f}" for n, m in split)
              + f"), plain {plain:.4f} ms, library {lib_what} {lib:.4f} ms "
              f"(rel err {lib_rel:.1e})"
              + (f", {alt[1]} {alt_ms:.4f} ms{alt_err}"
                 if alt is not None else "")
              + f"; rel err {rel:.2e} (tol {tol:g}){extra}; bound by {b_by} "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if name is not None:
            summary[name] = dict(max_abs_err=diff, ms=ms, plain_ms=plain,
                                 library_ms=lib, bound_ms=b_ms,
                                 bound_by=b_by)
    del w32, wm32, w16, wm16, x32, dy32, dyc32, u32, s32, v32
    for name in sweep:
        summary[name]["max_abs_err"] = max(worst[name][1],
                                           summary[name]["max_abs_err"])

    # mesh_apply's wide routes at the realization's shape: 2,048 reck
    # meshes of k = 128 (the up projection's U and V* meshes), the unrolled
    # route in turns with the list-driven one forced on the same meshes
    k, nm = 128, 2048
    spec = un.mesh_spec(k, "reck")
    ph = torch.rand(nm, spec.n_rot, generator=gen, device=dev) * 4 * torch.pi
    d = torch.where(torch.rand(nm, k, generator=gen, device=dev) < 0.5,
                    1.0, -1.0)
    eye = torch.eye(k, device=dev)[None]

    def mesh_new():
        return un.build_unitary(spec, ph, d)

    def mesh_old():
        return mesh_apply_batched(spec, ph, eye, d, transpose_out=True,
                                  force_route="wide")

    want = mesh_apply_plain(spec, ph, eye, d, transpose_out=True)
    for name, fn in zip(mesh_names, (mesh_old, mesh_new)):
        uu = fn()
        err = float((uu - want).abs().max())
        check(err < 1e-5, f"{name} {nm} reck meshes: max abs err {err:.2e} "
                          f">= 1e-5")
        check(torch.equal(uu, fn()), f"{name} {nm} reck meshes: two runs "
                                     f"differ")
        mesh_worst[name] = max(mesh_worst[name], err)
    orth = max(orth, float((uu @ uu.transpose(1, 2) - eye).abs().max()))
    check(orth < 1e-4, f"mesh_apply wide routes: U U^T - I {orth:.2e}")
    del uu, want
    times = [cuda_ms(f, 5) for f in (mesh_new, mesh_old, mesh_old, mesh_new)]
    plain = cuda_ms(lambda: mesh_apply_plain(spec, ph, eye, d,
                                             transpose_out=True), 2)
    t_rot, layers = spec.n_rot, spec.n_layers
    # per mesh: one sincos (counted as 2 operations) per phase, 6 per
    # rotation per row, one sign multiply per wire per row; bytes: phases,
    # signs, the identity and U (the list-driven route also reads its
    # rotation tables)
    flops = nm * (2 * t_rot + k * (6 * t_rot + k))
    nbytes = 4 * (nm * t_rot + nm * k + k * k + nm * k * k)
    print(f"[check] mesh_apply wide routes: k 33/64/100/128 x reck/clements "
          f"(64 and 128 unrolled, with signs and without), build_unitary "
          f"and 70 rows of their own, and {nm} reck meshes of k = {k} on "
          f"both: max abs err " + ", ".join(
              f"{n} {e:.2e}" for n, e in mesh_worst.items())
          + f" (tol 1e-5); U U^T - I {orth:.1e} (tol 1e-4); reruns bitwise")
    for name, (t0, t1), extra in (
            ("mesh_apply_wide_unrolled", (times[0], times[3]), 0),
            ("mesh_apply_wide", (times[1], times[2]),
             4 * (2 * t_rot + layers + 1))):
        ms = min(t0, t1)
        b_ms, b_by = bound_ms(flops, nbytes + extra)
        print(f"[time] {name} build_unitary ({nm} reck meshes x {k} rows, "
              f"{t_rot} phases in {layers} layers"
              + (", forced" if name == "mesh_apply_wide" else "")
              + f"): kernel {ms:.4f} ms; in turns {t0:.4f}, {t1:.4f} "
              f"({100 * b_ms / ms:.1f}% of the bound), plain {plain:.4f} ms, "
              f"no one-call yardstick, bound {b_ms:.4f} ms ({b_by}; "
              f"{flops / 1e9:.2f} GFLOP, {(nbytes + extra) / 1e6:.1f} MB)")
        summary[name] = dict(max_abs_err=mesh_worst[name], ms=ms,
                             plain_ms=plain, library_ms=None, bound_ms=b_ms,
                             bound_by=b_by)
    return summary


def engine_scatter_idx(n_periods: int, slots: int, chunk: int,
                       n_pages: int, page_size: int, pages_per_slot: int,
                       lens, take):
    """(P·B·C, 2) scatter targets as the gateway builds them
    (``engine._scatter_chunk``): slot b's first ``take[b]`` rows at its
    consecutive positions from ``lens[b]`` in its own pages, every other
    row on the period's scratch page at offset 0 (duplicates)."""
    import numpy as np
    stripe = n_pages + 1
    idx = np.zeros((slots, chunk, 2), np.int32)
    idx[:, :, 0] = n_pages
    for b in range(slots):
        pos = lens[b] + np.arange(take[b])
        idx[b, :take[b], 0] = b * pages_per_slot + pos // page_size
        idx[b, :take[b], 1] = pos % page_size
    return np.concatenate([idx.reshape(-1, 2) + np.asarray(
        [[p * stripe, 0]], np.int32) for p in range(n_periods)])


def parent_prefill(torch, parent):
    """The earlier tree's CUDA-core ``prefill_attention`` (its C
    interface: key tiles of ``T`` keys, the largest divisor of ``blk`` up
    to 32) as a callable on fp32 inputs, or None."""
    import ctypes
    lib = parent_library(torch, parent, "prefill_attn", "int T, int window")
    if lib is None:
        return None
    fn = lib.prefill_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]

    def call(lens, q, k, v, blk):
        b, c, h, hd = q.shape
        s, hkv = k.shape[1], k.shape[2]
        tile = next(t for t in range(min(blk, 32), 0, -1) if blk % t == 0)
        out = torch.empty_like(q)
        status = fn(lens.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, c, h, hkv, hd, s, tile, 0, 0.0,
                    hd ** -0.5, 0, 0, torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"parent prefill_attention: CUDA error {status}")
        return out
    return call


def serving_kernels(torch, gen, parent=None) -> dict:
    """``paged_gather``, ``paged_scatter`` and ``prefill_attention`` against
    their plain versions (bitwise for the two copies), then timed at the
    qwen3-4b gateway's full-width shapes."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import (build, paged_gather, paged_scatter,
                                     prefill_attention, ref)
    from repro_torch.kernels.prefill_attn import NAME, NAME_CUDA_CORES
    from repro_torch.kernels.prefill_attn import _fn as prefill_fn_cc

    NAME_CC = NAME_CUDA_CORES
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def ids(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    summary = {}
    # the gateway's full width: qwen3-4b (36 layers, 8 KV heads of 128),
    # 8 slots, pages of 16 tokens, 320 pages (+1 scratch) per period,
    # tables of 40 pages (S_max 640), prefill chunk 64
    periods, slots, ps, n_pages, jmax, d, chunk = 36, 8, 16, 320, 40, 1024, 64
    pool_pages = periods * (n_pages + 1)

    # -- paged_gather: the reference test's geometry, odd row widths, and
    # at full width the table of a full gateway (every period's 8 slots
    # own all 320 pages of its stripe)
    for (npg, p_s, dd, b, j, dtype) in ((10, 4, 6, 3, 2, f32),
                                        (10, 4, 6, 3, 2, bf16),
                                        (7, 3, 5, 2, 3, bf16)):
        pages, table = randn(npg, p_s, dd, dtype=dtype), ids(npg, b, j)
        check(torch.equal(paged_gather(table, pages),
                          ref.paged_gather_ref(table, pages)),
              f"paged_gather {(npg, p_s, dd, b, j)} {dtype}: not bitwise "
              f"equal to pages[table]")
    pages = randn(pool_pages, ps, d, dtype=bf16)
    table = torch.cat([torch.randperm(n_pages, generator=gen, device=dev)
                       + p * (n_pages + 1) for p in range(periods)])
    table = table.to(torch.int32).reshape(periods * slots, jmax)
    out = paged_gather(table, pages)
    gather_err, _ = rel_err(out, ref.paged_gather_ref(table, pages))
    check(gather_err == 0.0 and torch.equal(out, ref.paged_gather_ref(
        table, pages)), "paged_gather full width: not bitwise equal to "
                        "pages[table]")
    view_bytes = out.numel() * out.element_size()
    ms = cuda_ms(lambda: paged_gather(table, pages), 20)
    plain = cuda_ms(lambda: ref.paged_gather_ref(table, pages), 20)
    lib = cuda_ms(lambda: pages[table], 20)
    # each page the table names read once, the views written once
    read = int(torch.unique(table).numel()) * ps * d * 2
    b_ms, b_by = bound_ms(0, read + view_bytes + table.numel() * 4)
    print(f"[check] paged_gather: test geometry fp32 + bf16, odd rows, full "
          f"width: bitwise equal to pages[table]")
    print(f"[time] paged_gather (table {tuple(table.shape)}, pages "
          f"{tuple(pages.shape)} bf16, view {view_bytes / 1e6:.1f} MB): "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library pages[table] "
          f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    summary["paged_gather"] = dict(max_abs_err=gather_err, ms=ms,
                                   plain_ms=plain,
                                   library_ms=lib, bound_ms=b_ms,
                                   bound_by=b_by)

    # -- paged_scatter: distinct targets (the reference test), heavy
    # duplicates (last-wins), and the gateway's mid-run step at full width
    scatter_err = [0.0]

    def scatter_case(pool, idx, rows, what):
        got = paged_scatter(idx, rows, pool.clone())
        want = ref.paged_scatter_ref(idx, rows, pool.clone())
        again = paged_scatter(idx, rows, pool.clone())
        scatter_err[0] = max(scatter_err[0], rel_err(got, want)[0])
        check(torch.equal(got, want), f"paged_scatter {what}: not bitwise "
                                      f"equal to the last-wins plain version")
        check(torch.equal(got, again), f"paged_scatter {what}: two runs "
                                       f"differ")

    pool = randn(8, 4, 5)
    idx = torch.tensor([[2, 1], [5, 0], [2, 3]], dtype=torch.int32,
                       device=dev)
    scatter_case(pool, idx, randn(3, 5), "test geometry")
    for dtype in (f32, bf16):
        dup = torch.stack([ids(6, 4096), ids(4, 4096)], dim=1)
        scatter_case(randn(6, 4, 7, dtype=dtype), dup,
                     randn(4096, 7, dtype=dtype), f"duplicates {dtype}")
    rng = np.random.default_rng(0)
    lens = rng.integers(0, 512, slots)
    take = np.asarray([64, 64, 64, 1, 1, 1, 0, 0])    # prefill, decode, idle
    idx = torch.as_tensor(engine_scatter_idx(
        periods, slots, chunk, n_pages, ps, jmax, lens, take), device=dev)
    rows = randn(idx.shape[0], d, dtype=bf16)
    pool = randn(pool_pages, ps, d, dtype=bf16)
    scatter_case(pool, idx, rows, "full width")
    flat = (idx[:, 0].long() * ps + idx[:, 1].long())
    winners = int(torch.unique(flat).numel())
    print(f"[check] paged_scatter: test geometry, 4096 rows onto 24 targets "
          f"(fp32 + bf16), full width ({idx.shape[0]} rows, {winners} "
          f"distinct targets): bitwise equal to the last-wins plain version, "
          f"two runs equal")
    ms = cuda_ms(lambda: paged_scatter(idx, rows, pool), 20)
    plain = cuda_ms(lambda: ref.paged_scatter_ref(idx, rows, pool), 20)
    lib = cuda_ms(lambda: pool.view(-1, d).index_put_((flat,), rows), 20)
    # least bytes: the targets read once (last-wins needs only them to
    # pick the winners), each winning row read once and written once; a
    # row that loses to a later one need never be read
    nbytes = idx.numel() * 4 + 2 * winners * d * 2
    b_ms, b_by = bound_ms(0, nbytes)
    print(f"[time] paged_scatter ({idx.shape[0]} rows of {d} bf16, "
          f"{winners} written): kernel {ms:.4f} ms, plain (last-wins + "
          f"index_put_) {plain:.4f} ms, library index_put_ alone {lib:.4f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}: targets read, winning rows "
          f"read and written, {nbytes / 1e6:.1f} MB)")
    summary["paged_scatter"] = dict(max_abs_err=scatter_err[0], ms=ms,
                                    plain_ms=plain,
                                    library_ms=lib, bound_ms=b_ms,
                                    bound_by=b_by)

    # -- prefill_attention, CUDA-core route (fp32 q, and the pairs the
    # tensor cores do not take): the reference test sweep, masked-block
    # exactness, the smoke LM's mixed types, and the full-width step at fp32
    tc_before = build.launch_counts[NAME]
    cc_before = build.launch_counts[NAME_CC]
    worst = 0.0
    b, c, h, hkv, hd, s = 3, 5, 4, 2, 8, 24
    lens = torch.tensor([0, 7, 19], dtype=torch.int32, device=dev)
    q, k, v = randn(b, c, h, hd), randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    for blk in (None, 8, 4):
        for window, cap in ((None, None), (6, None), (None, 3.0), (5, 2.0)):
            kw = dict(blk=blk, window=window, cap=cap)
            got = prefill_attention(lens, q, k, v, **kw)
            err = float((got - ref.prefill_attention_ref(
                lens, q, k, v, window=window, cap=cap)).abs().max())
            check(err < 2e-5, f"prefill_attention {kw}: max abs err "
                              f"{err:.2e} >= 2e-5")
            check(torch.equal(got, prefill_attention(lens, q, k, v, **kw)),
                  f"prefill_attention {kw}: two runs differ")
            worst = max(worst, err)
    lens1 = torch.tensor([12], dtype=torch.int32, device=dev)
    q1, k1, v1 = randn(1, 2, 2, 4), randn(1, 16, 1, 4), randn(1, 16, 1, 4)
    base = prefill_attention(lens1, q1, k1, v1, blk=4, window=3)
    k2, v2 = k1.clone(), v1.clone()
    k2[:, :8], v2[:, :8] = 999.0, -999.0
    check(torch.equal(base, prefill_attention(lens1, q1, k2, v2, blk=4,
                                              window=3)),
          "prefill_attention: a block outside the window changed the output")
    qm, km, vm = q.clone(), k.to(bf16), v.to(bf16)     # the smoke LM's types
    err = float((prefill_attention(lens, qm, km, vm, blk=8) - ref.
                 prefill_attention_ref(lens, qm, km, vm)).abs().max())
    check(err < 2e-5, f"prefill_attention fp32 q, bf16 kv: max abs err "
                      f"{err:.2e} >= 2e-5")
    worst = max(worst, err)

    b, c, h, hkv, hd, s, blk = slots, chunk, 32, 8, 128, 640, 64
    lens = torch.linspace(0, 576, b, device=dev).to(torch.int32)
    q, k, v = randn(b, c, h, hd), randn(b, s, hkv, hd), randn(b, s, hkv, hd)
    out = prefill_attention(lens, q, k, v, blk=blk)
    err = float((out - ref.prefill_attention_ref(lens, q, k, v)).abs().max())
    check(err < 2e-5, f"prefill_attention full width fp32: max abs err "
                      f"{err:.2e} >= 2e-5")
    worst = max(worst, err)
    # a planted fault the limit must catch: the plain version's causal
    # mask one key too wide (query c also sees key lens + c + 1)
    leak = float((out - ref.prefill_attention_ref(lens + 1, q, k, v))
                 .abs().max())
    check(leak > 2e-5, f"prefill_attention full width fp32: a one-key "
                       f"mask leak reads {leak:.2e}, inside 2e-5")
    check(build.launch_counts[NAME] == tc_before,
          "prefill_attention: an fp32 call went to the tensor-core kernel")
    n_cc = build.launch_counts[NAME_CC] - cc_before
    print(f"[check] prefill_attention, CUDA-core route ({n_cc} launches): "
          f"12 (blk, window, cap) cases + fp32 q over bf16 kv + full width "
          f"fp32: max abs err {worst:.2e} (tol 2e-5; a one-key mask leak "
          f"reads {leak:.2e}), two runs equal; masked block exact")
    q32, k32, v32 = q, k, v
    cc_abs = worst
    ms_cc32 = cuda_ms(lambda: prefill_attention(lens, q32, k32, v32,
                                                blk=blk), 20)
    plain_cc32 = cuda_ms(lambda: ref.prefill_attention_ref(lens, q32, k32,
                                                           v32), 3)

    # -- prefill_attention, tensor-core route (bf16 q over bf16 K/V, Dh 64
    # and 128): the 12 (blk, window, cap) cases at GQA ratios 1, 2, 4 and
    # 16, C·rep not a multiple of the 64-row tile, lens at 0 and at S - C,
    # S not a multiple of the 64-key tile; reruns bitwise, a block outside
    # the window changes no bit, a one-key leak reads above the limit
    tc_tol = 2 ** -7
    tc_worst, tc_abs, n_tc = 0.0, 0.0, 0
    tc_before = build.launch_counts[NAME]
    cc_before = build.launch_counts[NAME_CC]
    for (b, c, h, hkv, hd, s, ln) in (
            (3, 13, 8, 2, 128, 200, [0, 100, 187]),   # rep 4, 52 rows
            (2, 5, 16, 1, 64, 72, [0, 67]),           # rep 16, 80 rows
            (2, 37, 3, 3, 64, 136, [0, 99]),          # rep 1, 37 rows
            (2, 50, 4, 2, 128, 640, [0, 590])):       # rep 2, 100 rows
        lens = torch.tensor(ln, dtype=torch.int32, device=dev)
        q, k, v = (randn(b, c, h, hd, dtype=bf16),
                   randn(b, s, hkv, hd, dtype=bf16),
                   randn(b, s, hkv, hd, dtype=bf16))
        for blk in (None, 8, 4):
            for window, cap in ((None, None), (6, None), (None, 3.0),
                                (5, 2.0)):
                kw = dict(blk=blk, window=window, cap=cap)
                what = f"bf16 {(b, c, h, hkv, hd, s, ln)} {kw}"
                got = prefill_attention(lens, q, k, v, **kw)
                diff, rel = rel_err(got, ref.prefill_attention_ref(
                    lens, q, k, v, window=window, cap=cap))
                check(rel <= tc_tol, f"prefill_attention {what}: max abs "
                                     f"err {rel:.2e} of the largest |out| > "
                                     f"2^-7")
                check(torch.equal(got, prefill_attention(lens, q, k, v,
                                                         **kw)),
                      f"prefill_attention {what}: two runs differ")
                tc_worst, tc_abs = max(tc_worst, rel), max(tc_abs, diff)
                n_tc += 2
        leak = rel_err(prefill_attention(lens, q, k, v),
                       ref.prefill_attention_ref(lens + 1, q, k, v))[1]
        check(leak > tc_tol, f"prefill_attention bf16 {(b, c, h, hkv, hd)}: "
                             f"a one-key mask leak reads {leak:.2e}, inside "
                             f"2^-7")
        n_tc += 1
    lens1 = torch.tensor([128], dtype=torch.int32, device=dev)
    q1, k1, v1 = (randn(1, 8, 4, 64, dtype=bf16),
                  randn(1, 136, 2, 64, dtype=bf16),
                  randn(1, 136, 2, 64, dtype=bf16))
    base = prefill_attention(lens1, q1, k1, v1, window=20)
    k2, v2 = k1.clone(), v1.clone()
    # keys 0-100 lie before every query's window (keys > 108): tile 0 is
    # skipped, tile 1 masks them inside a live tile
    k2[:, :101], v2[:, :101] = 999.0, -999.0
    check(torch.equal(base, prefill_attention(lens1, q1, k2, v2, window=20)),
          "prefill_attention bf16: a block outside the window changed the "
          "output")
    n_tc += 2
    check(build.launch_counts[NAME] - tc_before == n_tc
          and build.launch_counts[NAME_CC] == cc_before,
          f"prefill_attention: {build.launch_counts[NAME] - tc_before} of "
          f"{n_tc} bf16 calls went to the tensor-core kernel")

    b, c, h, hkv, hd, s, blk = slots, chunk, 32, 8, 128, 640, 64
    lens = torch.linspace(0, 576, b, device=dev).to(torch.int32)
    q, k, v = (t.to(bf16) for t in (q32, k32, v32))
    out = prefill_attention(lens, q, k, v, blk=blk)
    want = ref.prefill_attention_ref(lens, q, k, v)
    diff, rel = rel_err(out, want)
    check(rel <= tc_tol, f"prefill_attention full width bf16: rel err "
                         f"{rel:.2e} > 2^-7")
    tc_worst, tc_abs = max(tc_worst, rel), max(tc_abs, diff)
    print(f"[check] prefill_attention, tensor-core route ({n_tc + 1} "
          f"launches): 12 (blk, window, cap) cases x Dh 64/128, rep "
          f"1/2/4/16, ragged rows and keys, lens 0 and S - C, and the full "
          f"width: max abs err {tc_abs:.2e}, {tc_worst:.2e} of the largest "
          f"|out| (tol 2^-7); two runs equal; masked block exact; one-key "
          f"mask leak caught in every geometry")

    # the earlier design, the CUDA-core kernel, on the same bf16 inputs,
    # timed beside the tensor-core kernel in this run
    def cuda_core_bf16():
        o = torch.empty_like(q)
        status = prefill_fn_cc()(
            lens.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), b, c, h, hkv, hd, s, 0, 0.0,
            hd ** -0.5, 1, 1, torch.cuda.current_stream().cuda_stream)
        build.check_status("prefill_attn", status)
        return o
    _, cc_rel = rel_err(cuda_core_bf16(), want)
    ms_cc16 = cuda_ms(cuda_core_bf16, 20)
    ms = cuda_ms(lambda: prefill_attention(lens, q, k, v, blk=blk), 20)
    plain = cuda_ms(lambda: ref.prefill_attention_ref(lens, q, k, v), 3)
    qi = lens.long()[:, None] + torch.arange(c, device=dev)[None, :]
    mask = (torch.arange(s, device=dev)[None, None, :]
            <= qi[:, :, None])[:, None]                      # (B, 1, C, S)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def library():
        try:
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        except TypeError:       # a PyTorch without enable_gqa
            return F.scaled_dot_product_attention(
                qt, kt.repeat_interleave(h // hkv, 1),
                vt.repeat_interleave(h // hkv, 1), attn_mask=mask)
    _, lib_rel = rel_err(library().transpose(1, 2), want)
    lib = cuda_ms(library, 20)
    # least work: each live (query, key) pair once per query head, 2·Dh for
    # q·k and 2·Dh for p·v; bytes: q and out once, each slot's K/V rows up
    # to its last query position once
    live = int(torch.minimum(qi + 1, torch.tensor(s, device=dev)).sum())
    flops = 4 * hd * h * live
    kv_rows = int(torch.clamp(lens.long() + c, max=s).sum())
    nbytes = 2 * (2 * q.numel() + 2 * kv_rows * hkv * hd) + 4 * b
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"[time] prefill_attention (B={b}, C={c}, H={h}, Hkv={hkv}, "
          f"Dh={hd}, S={s}, blk={blk}, lens {lens.tolist()}, bf16; {live} "
          f"live pairs per head): tensor-core kernel {ms:.4f} ms "
          f"({100 * b_ms / ms:.0f}% of the bound), the CUDA-core kernel "
          f"on the same bf16 inputs {ms_cc16:.4f} ms (rel err "
          f"{cc_rel:.1e}), plain {plain:.4f} ms, library "
          f"scaled_dot_product_attention with a boolean mask (rel err "
          f"{lib_rel:.1e}) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{flops / 1e9:.2f} GFLOP at the bf16 tensor-core peak, "
          f"{nbytes / 1e6:.1f} MB)")
    summary["prefill_attention"] = dict(max_abs_err=tc_abs, ms=ms,
                                        plain_ms=plain, library_ms=lib,
                                        bound_ms=b_ms, bound_by=b_by)
    # the CUDA-core route at the same shape in fp32: the same least work
    # over the fp32 peak, 4-byte elements; the library call on fp32 inputs
    q32t, k32t, v32t = (t.transpose(1, 2) for t in (q32, k32, v32))

    def library32():
        try:
            return F.scaled_dot_product_attention(
                q32t, k32t, v32t, attn_mask=mask, enable_gqa=True)
        except TypeError:
            return F.scaled_dot_product_attention(
                q32t, k32t.repeat_interleave(h // hkv, 1),
                v32t.repeat_interleave(h // hkv, 1), attn_mask=mask)
    lib32 = cuda_ms(library32, 20)
    b_ms32, b_by32 = bound_ms(flops, 2 * nbytes - 4 * b)
    old = parent_prefill(torch, parent)
    par = ""
    if old is not None:       # the parent tree's kernel, in turns with this
        want32 = ref.prefill_attention_ref(lens, q32, k32, v32)
        old_err = float((old(lens, q32, k32, v32, blk) - want32).abs().max())
        turns = [cuda_ms(lambda: old(lens, q32, k32, v32, blk), 20),
                 cuda_ms(lambda: prefill_attention(lens, q32, k32, v32,
                                                   blk=blk), 20),
                 cuda_ms(lambda: prefill_attention(lens, q32, k32, v32,
                                                   blk=blk), 20),
                 cuda_ms(lambda: old(lens, q32, k32, v32, blk), 20)]
        par = (f", the parent tree's kernel {turns[0]:.4f} and "
               f"{turns[3]:.4f} ms in turns with this one's {turns[1]:.4f} "
               f"and {turns[2]:.4f} (parent max abs err {old_err:.1e})")
    print(f"[time] prefill_attention CUDA-core route, the same shape at "
          f"fp32: kernel {ms_cc32:.4f} ms ({100 * b_ms32 / ms_cc32:.0f}% of "
          f"the bound){par}, plain {plain_cc32:.4f} ms, library "
          f"scaled_dot_product_attention on the fp32 inputs {lib32:.4f} ms, "
          f"bound {b_ms32:.4f} ms ({b_by32}; {flops / 1e9:.2f} GFLOP at the "
          f"fp32 peak, {(2 * nbytes - 4 * b) / 1e6:.1f} MB)")
    summary[NAME_CC] = dict(max_abs_err=cc_abs, ms=ms_cc32,
                            plain_ms=plain_cc32, library_ms=lib32,
                            bound_ms=b_ms32, bound_by=b_by32)
    return summary


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path
# ---------------------------------------------------------------------------


def ptc_bridge_check(torch) -> None:
    """The PTC phase bridges on the card, at a (2, 2) grid of k = 9
    Clements blocks: ``factors_to_phases`` then ``phases_to_factors`` with
    no model recomposes a seeded weight's SVD factors to 1e-4 (the
    reference's tolerance); ``phases_to_factors`` with the quickstart's
    noise model on shared draws equals its plain version on the CPU to
    1e-5; each ``phases_to_factors`` launches the mesh kernel twice (one
    ``build_unitary`` a side) and no other kernel."""
    from repro_torch.core.noise import NoiseModel, sample_phase_noise
    from repro_torch.core.ptc import (PTCPhaseParams, compose_weight,
                                      factors_to_phases, phases_to_factors,
                                      svd_factorize, unblockize)
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(32)
    w = 0.3 * torch.randn((18, 18), generator=gen)
    ph = factors_to_phases(svd_factorize(w.to("cuda"), 9), kind="clements")
    check(ph.phi_u.device.type == "cuda" and ph.phi_u.shape == (2, 2, 36),
          f"bridges: phases {tuple(ph.phi_u.shape)} on {ph.phi_u.device}")

    def launched(fn):
        before = dict(build.launch_counts)
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in build.launch_counts.items()
                     if v != before[k]}

    ideal, n_ideal = launched(lambda: phases_to_factors(ph, kind="clements"))
    err_rt = (unblockize(compose_weight(ideal)).cpu() - w).abs().max().item()
    model = NoiseModel()        # the quickstart's: 8-bit Q, Γ, Ω, Φ_b
    nu, nv = (sample_phase_noise(gen, tuple(ph.phi_u.shape), model)
              for _ in range(2))
    noisy, n_noisy = launched(lambda: phases_to_factors(
        ph, type(nu)(*(a.cuda() for a in nu)),
        type(nv)(*(a.cuda() for a in nv)), kind="clements", model=model))
    plain = phases_to_factors(PTCPhaseParams(*(a.cpu() for a in ph)), nu, nv,
                              kind="clements", model=model)
    err_noisy = max((noisy.u.cpu() - plain.u).abs().max().item(),
                    (noisy.v.cpu() - plain.v).abs().max().item())
    print(f"[parity] PTC phase bridges, (2, 2) grid of k = 9 clements: "
          f"round trip max |W - W'| {err_rt:.3e} (limit 1e-4); noisy "
          f"factors vs plain (CPU) {err_noisy:.3e} (limit 1e-5); launches "
          f"{n_ideal} then {n_noisy} (2 mesh_apply each); "
          f"{time.perf_counter() - t0:.2f} s")
    check(err_rt < 1e-4, f"bridges: round trip off by {err_rt:.3e}")
    check(err_noisy < 1e-5, f"bridges: noisy factors off the plain version "
                            f"by {err_noisy:.3e}")
    check(n_ideal == n_noisy == {"mesh_apply": 2},
          f"bridges: phases_to_factors launched {n_ideal}, {n_noisy}, not "
          f"mesh_apply twice each")


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
    launches = {k: build.launch_counts[k] for k in QUICKSTART_KERNELS}
    print(f"[{name}] wall {time.perf_counter() - t0:.1f} s, launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items()))
    for kernel, n in launches.items():
        check(n > 0, f"{name}: {kernel} was not launched on the main path")
    for stage in QUICKSTART_STAGES:
        kernels = STAGE_KERNELS[stage]
        info = res["stages"][stage]
        counts = info["launches"]
        print(f"[{name}] stage {stage}: {info['seconds']:.2f} s, launches "
              + ", ".join(f"{k}={counts[k]}" for k in QUICKSTART_KERNELS))
        for kernel in kernels:
            check(counts[kernel] > 0,
                  f"{name}: {kernel} was not launched in {stage}")
        for kernel in PTC_ROUTES:
            check(kernel in kernels or counts[kernel] == 0,
                  f"{name}: {stage} launched {kernel} {counts[kernel]} "
                  f"times, not the route its entry names")

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


def busy_share(torch, job):
    """(host wall ms, kernel ms, launches, kernel events) of ``job()``: run
    once to warm up, once timed on the host (the card synchronized after),
    once under ``torch.profiler`` to sum its kernels' device time; None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    def synced():
        job()
        torch.cuda.synchronize()

    synced()                                # warm-up
    t0 = time.perf_counter()
    synced()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synced()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        return None
    return wall_ms, busy_ms, sum(e.count for e in kernels), kernels


def zo_busy_share(torch, res, steps: int = 20) -> None:
    """How busy the card is during an in-situ ZO job at full width: a
    short ``zo_refine`` on the mapped W1 chip, timed on the host, then
    run again under ``torch.profiler`` to sum its kernels' device time."""
    from repro_torch.core.mapping import default_pm_config
    from repro_torch.core.ptc import blockize

    driver = res["pms"][0].driver
    k = driver.k
    w_blocks = blockize(res["weights"][0], k).reshape(-1, k, k)
    cfg = default_pm_config(k * (k - 1) // 2)._replace(steps=steps)
    got = busy_share(torch, lambda: driver.zo_refine(
        w_blocks, torch.Generator("cuda").manual_seed(0), cfg))
    if got is None:
        print("[profile] zo_refine: the profiler saw no device time; "
              "device busy share not measured")
        return
    wall_ms, busy_ms, launches, kernels = got
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
# phase 3b: the closed loop on a two-chip fleet at full width
# ---------------------------------------------------------------------------


# the loop's drift.  The deployment floor at k = 9 is 0.0063-0.0074 (the
# phase prints it), and on the port's CPU build a post-IC chip carrying
# both VGG-8 head weights drifts as d(t) ≈ floor + 15.8 σ² (1 − e^{−2θt})/2θ
# (θ = 0.01; σ = 0.004, 0.006, 0.008 read 0.0187, 0.0337, 0.0544 at t = 150,
# 0.0161 for σ = 0.008 at t = 10).  σ = 0.012 gives 0.044 at t = 20, 0.058
# at 30 and 0.069 at 40: the probes of ticks 30 and 40 read above the 0.05
# alarm (two strikes) on both chips, so the first alarm fires at tick 40,
# the one repair slot re-tunes the four tenants one after another by about
# tick 60 (a partial recal from 0.069 read 0.011 on the CPU), and the
# repaired tenants cross again near tick 100: two rounds of alarms and
# repairs in CLOSED_LOOP_TICKS.
CLOSED_LOOP_SIGMA = 0.012
CLOSED_LOOP_TICKS = 120
CLOSED_LOOP_ROWS = 1024
# the loop against its plain versions, up to the first repair: the drift
# walk and the commanded state are the same bits in both runs (the same CPU
# draws, no kernel on their path), so only the realized meshes and the PTC
# products differ, each by fp32 rounding (about 1e-6 of an entry, the
# kernels phase's limit is 1e-4 absolute).  A distance d = ‖Ŵ − W‖²/‖W‖²
# moves by about 2 δŴ/√d relative to itself: 2e-6 / 0.08 = 2.5e-5 at the
# 0.0065 floor, less as d grows; a served batch's error likewise.  1e-4 is
# four times that.
CLOSED_LOOP_TOL = 1e-4


def _fleet_snapshot(chips):
    """Every piece of fleet state the loop changes: each twin's drift state,
    commanded phases and Σ, drift chain and meter; each chip's and
    tenant's status, health and counters.  (The twins replace these tensors
    and never write into them, so keeping the references is a copy.)"""
    import dataclasses
    from repro_torch.runtime.fleet import Chip, Tenant
    snap = []
    for c in chips:
        d = c.driver
        snap.append(dict(
            state=d._state, phi=d._phi, sigma=d._sigma,
            gen=d._drift_gen.get_state(), stats=d.stats.as_dict(),
            chip={f.name: getattr(c, f.name) for f in dataclasses.fields(Chip)
                  if f.name not in ("driver", "tenants")},
            tenants=[{f.name: getattr(t, f.name)
                      for f in dataclasses.fields(Tenant)}
                     for t in c.tenants]))
    return snap


def _fleet_restore(chips, snap):
    for c, sn in zip(chips, snap):
        d = c.driver
        d._state, d._phi, d._sigma = sn["state"], sn["phi"], sn["sigma"]
        d._drift_gen.set_state(sn["gen"])
        for cat, calls in sn["stats"].items():
            if cat != "total":
                setattr(d.stats, cat, calls)
        for name, val in sn["chip"].items():
            setattr(c, name, val)
        for t, vals in zip(c.tenants, sn["tenants"]):
            for name, val in vals.items():
                setattr(t, name, val)


def closed_loop_run(torch, chips, cfg, weights, what: str,
                    ticks: int = CLOSED_LOOP_TICKS) -> dict:
    """``ticks`` ticks of the loop as ``runtime.demo.simulate`` drives it: one batch of CLOSED_LOOP_ROWS rows a tick, round-robin over
    the tenants, then ``router.tick()`` and ``true_distances()``.  Each
    repair job is timed, its launches counted apart, and its co-tenants'
    commanded state and true distances held bit-identical across it."""
    from repro_torch.kernels import build
    from repro_torch.runtime.fleet import FleetRouter

    recals, aside = [], dict.fromkeys(CLOSED_LOOP_KERNELS, 0)

    def counts():
        return {k: build.launch_counts[k] for k in CLOSED_LOOP_KERNELS}

    class Router(FleetRouter):
        def _finish_recal(self, chip):
            c0 = counts()
            ten = chip.tenants[chip.recal_tenant or 0]
            lo, hi = ten.block_range
            h = chip.driver.unsafe_twin()
            others = [t for t in chip.tenants if t is not ten]
            phi0, sig0 = chip.driver._phi, chip.driver._sigma
            pre = [h.true_mapping_distance(t.w_blocks, t.block_range)
                   for t in others]
            c1 = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._finish_recal(chip)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c2 = counts()
            phi1, sig1 = chip.driver._phi, chip.driver._sigma
            for a, b in ((phi0, phi1), (sig0, sig1)):
                check(torch.equal(a[:lo], b[:lo])
                      and torch.equal(a[hi:], b[hi:]),
                      f"{what}: a partial recal of tenant {ten.tenant_id} "
                      f"moved a co-tenant's commanded state")
            post = [h.true_mapping_distance(t.w_blocks, t.block_range)
                    for t in others]
            check(pre == post, f"{what}: co-tenant true distances moved "
                               f"across a repair: {pre} -> {post}")
            after = h.true_mapping_distance(ten.w_blocks, ten.block_range)
            for k in aside:
                aside[k] += build.launch_counts[k] - c2[k] + c1[k] - c0[k]
            ev = self.events[-1]
            recals.append(dict(tick=self.tick_count, chip=chip.chip_id,
                               tenant=ten.tenant_id, wall=wall,
                               launches={k: c2[k] - c1[k] for k in c2},
                               dist_before=ev["dist_before"],
                               dist_after=ev["dist_after"],
                               true_after=after, zo_steps=ev["zo_steps"]))

    router = Router(chips, cfg, seed=1)
    gen = torch.Generator().manual_seed(2)
    trace = dict(dist=[], tenant_dist=[], serve_err=[], wall=[], served=[])
    c_start = counts()
    for t in range(1, ticks + 1):
        tenant = (t - 1) % len(weights)
        w = weights[tenant]
        x = torch.randn((CLOSED_LOOP_ROWS, w.shape[1]),
                        generator=gen).to("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, chip_id = router.serve(x, tenant=tenant)
        router.tick()
        dists = router.true_distances()
        torch.cuda.synchronize()
        trace["wall"].append(time.perf_counter() - t0)
        check(y is not None, f"{what}: tick {t}'s batch was dropped")
        y_ref = x @ w.T
        trace["serve_err"].append(float(torch.sum((y - y_ref) ** 2)
                                        / torch.sum(y_ref ** 2)))
        trace["dist"].append(dists)
        trace["tenant_dist"].append(router.true_tenant_distances())
        trace["served"].append(chip_id)
    c_end = counts()
    launches = {k: c_end[k] - c_start[k] - aside[k]
                - sum(r["launches"][k] for r in recals)
                for k in CLOSED_LOOP_KERNELS}
    return dict(router=router, trace=trace, recals=recals,
                tick_launches=launches, report=router.report())


def closed_loop_phase(torch, weights=None) -> dict:
    """A two-chip fleet carrying VGG-8's classifier head (W1 4096 -> 512,
    W2 512 -> 10, k = 9: 26,106 blocks a chip) under drift, with the
    demo's monitor and repair policy; the same loop with every kernel
    swapped for its plain version from the same deployed state; returns
    the launches of the kernel run (counts set to 0 just before it)."""
    from repro_torch.kernels import build
    from repro_torch.runtime.demo import default_runtime_config
    from repro_torch.runtime.fleet import make_fleet

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    if weights is None:
        # the full phase's shapes, seeded
        g = torch.Generator().manual_seed(0)
        weights = [torch.randn((512, 4096), generator=g) / 64.0,
                   torch.randn((10, 512), generator=g) / 512 ** 0.5]
        origin = "seeded"
    else:
        origin = "pre-trained by the full phase"
    weights = [w.detach().to(dev, torch.float32) for w in weights]
    cfg = default_runtime_config(k=9, sigma_drift=CLOSED_LOOP_SIGMA,
                                 probe_every=10)
    print(f"[closed_loop] 2 chips x tenants W1 {tuple(weights[0].shape)}, "
          f"W2 {tuple(weights[1].shape)} ({origin}), k = 9, post-IC noise, "
          f"sigma_drift {CLOSED_LOOP_SIGMA}, probes every {cfg.probe_every} "
          f"ticks ({cfg.monitor.n_probes} columns), alarm "
          f"{cfg.monitor.alarm_threshold} x{cfg.monitor.consecutive}, "
          f"clear {cfg.monitor.clear_threshold}, recal latency "
          f"{cfg.recal_latency}, {cfg.max_concurrent_recals} repair slot, "
          f"{cfg.recal.zo_steps} ZO steps a repair; {CLOSED_LOOP_TICKS} "
          f"ticks of {CLOSED_LOOP_ROWS} rows")

    info = build.build(sorted({build.KERNELS[k]
                               for k in CLOSED_LOOP_KERNELS}))
    if info["built"]:
        print(f"[closed_loop] built {info['built']} in "
              f"{info['seconds']:.1f} s")
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chips = make_fleet(torch.Generator().manual_seed(0), 2, weights, cfg,
                       device=dev)
    torch.cuda.synchronize()
    deploy_s = time.perf_counter() - t0
    stage = {"cl_deploy": {k: build.launch_counts[k]
                           for k in CLOSED_LOOP_KERNELS}}
    n_blocks = chips[0].driver.n_blocks
    floors = [[t.health.distance for t in c.tenants] for c in chips]
    print(f"[closed_loop] deploy (make_fleet: PM of both tenants on each "
          f"chip, its batched decomposition once per chip): "
          f"{deploy_s:.2f} s, {n_blocks} blocks a chip; deployment floor "
          f"(PM after OSP) " + ", ".join(
              f"chip {i} {f[0]:.5f} / {f[1]:.5f}"
              for i, f in enumerate(floors)))
    check(n_blocks == 26106, f"closed_loop: {n_blocks} blocks a chip")
    snap = _fleet_snapshot(chips)

    # the kernels' run, counted
    t0 = time.perf_counter()
    run = closed_loop_run(torch, chips, cfg, weights, "closed_loop")
    loop_s = time.perf_counter() - t0
    stage["cl_tick"] = run["tick_launches"]
    stage["cl_recal"] = {k: sum(r["launches"][k] for r in run["recals"])
                         for k in CLOSED_LOOP_KERNELS}
    launches = {k: sum(stage[s][k] for s in CLOSED_LOOP_STAGES)
                for k in CLOSED_LOOP_KERNELS}
    for name in CLOSED_LOOP_STAGES:
        counts = stage[name]
        print(f"[closed_loop] stage {name}: launches "
              + ", ".join(f"{k}={counts[k]}" for k in CLOSED_LOOP_KERNELS))
        for kernel in STAGE_KERNELS[name]:
            check(counts[kernel] > 0,
                  f"closed_loop: {kernel} was not launched in {name}")
        for kernel in PTC_ROUTES:
            check(kernel in STAGE_KERNELS[name] or counts[kernel] == 0,
                  f"closed_loop: {name} launched {kernel} {counts[kernel]} "
                  f"times, not the route its entry names")
    tr, rep, router = run["trace"], run["report"], run["router"]
    recal_ticks = {r["tick"] for r in run["recals"]}
    walls = [w for i, w in enumerate(tr["wall"], 1) if i not in recal_ticks]
    med = sorted(walls)[len(walls) // 2]
    print(f"[closed_loop] loop {loop_s:.2f} s: a tick (serve, tick, true "
          f"distances) median {1e3 * med:.2f} ms, mean "
          f"{1e3 * sum(walls) / len(walls):.2f} ms over the "
          f"{len(walls)} ticks without a repair landing; per tick "
          + ", ".join(f"{k} {v / CLOSED_LOOP_TICKS:.1f}"
                      for k, v in stage["cl_tick"].items()))
    for ev in rep["events"]:
        print(f"[closed_loop] event t={ev['tick']}: " + ", ".join(
            f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in ev.items() if k != "tick"))
    print("[closed_loop] max true distance every 10 ticks: " + " ".join(
        f"{t}:{max(tr['dist'][t - 1]):.4f}"
        for t in range(10, CLOSED_LOOP_TICKS + 1, 10)))
    for r in run["recals"]:
        print(f"[closed_loop] recal t={r['tick']} chip {r['chip']} tenant "
              f"{r['tenant']}: dist_before {r['dist_before']:.5f}, "
              f"dist_after {r['dist_after']:.5f} (true {r['true_after']:.5f})"
              f", zo_steps {r['zo_steps']}, {r['wall']:.2f} s, launches "
              + ", ".join(f"{k}={v}" for k, v in r["launches"].items()))
    for c in rep["chips"]:
        print(f"[closed_loop] chip {c['chip']} PTC calls "
              + ", ".join(f"{k} {v:.0f}" for k, v in c["ptc_calls"].items())
              + f"; served {c['served']}, alarms {c['alarms']}, recals "
              f"{c['recals']}, status {c['status']}")

    clear = cfg.monitor.clear_threshold
    alarms = [ev for ev in rep["events"] if ev["event"] == "alarm"]
    dones = [ev for ev in rep["events"] if ev["event"] == "recal_done"]
    check(max(max(d) for d in tr["dist"]) > cfg.monitor.alarm_threshold,
          "closed_loop: the fleet never degraded past the alarm threshold")
    check(alarms, "closed_loop: no alarm fired")
    check(dones and all(r["dist_after"] < clear and r["true_after"] < clear
                        for r in run["recals"]),
          f"closed_loop: a repair did not clear below {clear}: "
          f"{[(r['dist_after'], r['true_after']) for r in run['recals']]}")
    check(rep["dropped"] == 0, "closed_loop: batches were dropped")
    for kernel in CLOSED_LOOP_KERNELS:
        check(launches[kernel] > 0,
              f"closed_loop: {kernel} was not launched on the path")

    # forward_many against separate forwards, bit for bit, on the card
    drv = chips[0].driver
    g = torch.Generator().manual_seed(3)
    xs = [torch.randn((6, 9), generator=g).to(dev) for _ in range(30)]
    many = drv.forward_many(xs)
    check(all(torch.equal(a, drv.forward(x)) for a, x in zip(many, xs)),
          "closed_loop: forward_many differs from separate forwards")
    batched = drv.run_batch([("forward", dict(x=x)) for x in xs[:4]])
    check(all(torch.equal(a, b) for a, b in zip(batched, many[:4])),
          "closed_loop: a coalesced run_batch differs from forward")
    print(f"[closed_loop] forward_many of 30 six-column probes over "
          f"{drv.n_blocks} blocks equals 30 forwards bit for bit "
          f"(run_batch's coalesced span too)")

    # the same loop from the same deployed state, the kernels swapped for
    # their plain versions, through the tick its first repair lands
    ev_k = rep["events"]
    first = next(i for i, ev in enumerate(ev_k) if ev["event"] == "recal_done")
    tick_done = ev_k[first]["tick"]
    _fleet_restore(chips, snap)
    t0 = time.perf_counter()
    with plain_kernels(torch, "closed_loop"):
        plain = closed_loop_run(torch, chips, cfg, weights,
                                "closed_loop plain", ticks=tick_done)
    plain_s = time.perf_counter() - t0
    ev_p = plain["report"]["events"]
    worst = 0.0
    for a, b in zip(ev_k[:first + 1], ev_p[:first + 1]):
        same = {k: v for k, v in a.items()
                if not isinstance(v, float)} == \
            {k: v for k, v in b.items() if not isinstance(v, float)}
        check(same, f"closed_loop: timelines part before the first repair "
                    f"landed: {a} vs {b}")
        if a["event"] == "alarm":
            worst = max(worst, abs(a["distance"] - b["distance"])
                        / a["distance"])
    for t in range(tick_done - 1):
        for dk, dp in zip(tr["tenant_dist"][t], plain["trace"]["tenant_dist"][t]):
            for a, b in zip(dk, dp):
                worst = max(worst, abs(a - b) / a)
        a, b = tr["serve_err"][t], plain["trace"]["serve_err"][t]
        worst = max(worst, abs(a - b) / a)
    check(worst < CLOSED_LOOP_TOL,
          f"closed_loop: kernels vs plain versions rel {worst:.2e} >= "
          f"{CLOSED_LOOP_TOL} before the first repair")
    p_recals = plain["recals"]
    check(p_recals and all(r["dist_after"] < clear and r["true_after"] < clear
                           for r in p_recals),
          "closed_loop plain: a repair did not clear")
    print(f"[closed_loop] plain versions, same deployed state and draws, "
          f"{tick_done} ticks: {plain_s:.2f} s; timeline equal through the "
          f"first repair (tick {tick_done}), true distances, alarm "
          f"estimates and serve errors within rel {worst:.2e} (tol "
          f"{CLOSED_LOOP_TOL}) before it; its repair: kernels "
          f"{run['recals'][0]['dist_after']:.5f} in "
          f"{run['recals'][0]['wall']:.2f} s, plain "
          f"{p_recals[0]['dist_after']:.5f} in {p_recals[0]['wall']:.2f} s "
          f"(clear {clear})")
    print(f"[closed_loop] phase {time.perf_counter() - t_phase:.1f} s")
    del chips, snap
    torch.cuda.empty_cache()
    return launches


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
          + ", ".join(f"{k}={counts[k]}" for k in QUICKSTART_KERNELS))
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
    by_kernel = {}
    for e in kernels:
        name = next((n for n, pat in KERNEL_FAMILIES.items()
                     if re.search(pat, e.key)), "other")
        ms, n = by_kernel.get(name, (0.0, 0))
        by_kernel[name] = (ms + e.self_device_time_total / 3e3, n + e.count / 3)
    print("[profile] vgg8 kernel time per step by kernel: " + "; ".join(
        f"{name} {ms:.3f} ms in {n:.0f} launches" for name, (ms, n) in
        sorted(by_kernel.items(), key=lambda kv: -kv[1][0])))


# ---------------------------------------------------------------------------
# phase 5: the blocked PTC path at LM width
# ---------------------------------------------------------------------------


# the step's kernel-vs-plain limit, of the largest entry: y, dx and the
# Σ-gradient leave the step rounded to bf16 (the reference's dtypes), and
# two fp32 sums that agree to 1e-6 can round one bf16 ulp apart, up to
# 2^-7 of the largest entry; the tensor-core forward also rounds U diag(s)
# and W to bf16, about 2^-9 of a typical |y|, under one ulp of the largest
# (the kernels themselves are held to 1e-4 in fp32, and ds before its
# rounding, in the kernels phase)
BLOCKED_LM_TOL = 2 ** -7


def warm_profile(torch, what: str, step, families, tag: str = "blocked_lm"
                 ) -> float:
    """Print a warm step's wall, then its device time by kernel family
    ((name, regex of device function names) pairs; the rest "other") from
    ``torch.profiler`` over 3 warm steps; returns the warm wall in ms.
    ``tag`` heads the printed lines."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[{tag}] {what} step again (warm): wall {wall_ms:.1f} ms")
    split = device_split(step, 3)
    by_family = {}
    for kname, ms in split:
        fam = next((f for f, pat in families if re.search(pat, kname)),
                   "other")
        by_family[fam] = by_family.get(fam, 0.0) + ms
    total = sum(by_family.values())
    if total == 0:
        print(f"[{tag}] the profiler saw no device time: the {what} "
              f"step's kernel time not measured")
        return wall_ms
    print(f"[{tag}] warm {what} step, device time by kernel "
          f"(torch.profiler, 3 steps): {total:.3f} ms of kernels: "
          + ", ".join(f"{f} {m:.3f} ms" for f, m in sorted(
              by_family.items(), key=lambda kv: -kv[1]))
          + "; by launch: " + ", ".join(
              f"{n} {m:.3f}" for n, m in sorted(split,
                                                key=lambda e: -e[1])[:8]))
    return wall_ms


def blocked_lm_phase(torch) -> dict:
    """olmo-1b's seven PTC linears of one decoder layer in blocked mode at
    full width (k = 128, bf16 bases): one step, forward and autograd
    through ``models/layers.py::apply_ptc_linear`` with sampled feedback
    and column masks, held against the same step through the plain
    versions; then the up projection's 1,024 blocks realized through
    ``hw/device.py::realized_unitaries`` (2,048 reck meshes of k = 128).
    The bf16 step takes the three tensor-core routes; the same step with
    fp32 bases the three 3xTF32 routes.  Returns the wide routes'
    launches: the tensor-core routes' over the bf16 step, the 3xTF32 and
    CUDA-core routes' over the fp32 step, the wide mesh routes' over the
    realization."""
    from repro_torch.configs import get_config
    from repro_torch.core import subspace
    from repro_torch.core import unitary as un
    from repro_torch.core.noise import NoiseModel, apply_phase_noise
    from repro_torch.core.ptc import PTCParams
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.hw.device import realized_unitaries, sample_device
    from repro_torch.kernels import build, mesh_apply_plain
    from repro_torch.models.layers import (PTCLinearCfg, apply_ptc_linear,
                                           init_ptc_linear)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    arch = get_config("olmo-1b")
    check((arch.d_model, arch.d_ff) == (2048, 8192),
          f"blocked_lm: olmo-1b is {arch.d_model} / {arch.d_ff} wide")
    cfg = PTCLinearCfg(k=128, mode="blocked", base_dtype=torch.bfloat16)
    t = BLOCKED_LM_T
    scfg = SparsityConfig(alpha_w=0.6, alpha_c=0.6)
    t0 = time.perf_counter()
    layers = {name: init_ptc_linear(gen, d_in, d_out, cfg)
              for name, d_in, d_out in OLMO_LINEARS}
    # the layer's inputs: q, k, v read the attention input, gate and up
    # the FFN input, o and down their own
    reads = {"q": "attn", "k": "attn", "v": "attn", "o": "o", "gate": "ffn",
             "up": "ffn", "down": "down"}
    widths = {"attn": 2048, "o": 2048, "ffn": 2048, "down": 8192}
    xs = {n: torch.randn((t, w), generator=gen, device=dev)
          for n, w in widths.items()}
    masks = {name: subspace.sample_masks(
        gen, PTCParams(p["u"], p["s"].to(p["u"].dtype), p["v"]), t, scfg)
        for name, p in layers.items()}
    dys = {name: torch.randn((t, d_out), generator=gen, device=dev)
           .to(torch.bfloat16) for name, _, d_out in OLMO_LINEARS}
    torch.cuda.synchronize()
    print(f"[blocked_lm] olmo-1b, one decoder layer's PTC linears in blocked"
          f" mode, k = {cfg.k}, bases {cfg.base_dtype}: " + ", ".join(
              f"{n} {p['s'].shape[1] * cfg.k}->{p['s'].shape[0] * cfg.k} "
              f"(P {p['s'].shape[0]}, Q {p['s'].shape[1]}, feedback keeps "
              f"{int(torch.count_nonzero(masks[n].feedback))})"
              for n, p in layers.items())
          + f"; T = {t} (one train_4k sequence), alpha_w 0.6, alpha_c 0.6; "
          f"cuts: depth 16 -> 1 layer, batch 256 -> 1 sequence; init "
          f"{time.perf_counter() - t0:.1f} s")

    def step(layers=layers, cfg=cfg, dys=dys):
        s_leaf = {n: p["s"].detach().clone().requires_grad_()
                  for n, p in layers.items()}
        x_leaf = {n: x.detach().clone().requires_grad_()
                  for n, x in xs.items()}
        ys = {n: apply_ptc_linear(dict(p, s=s_leaf[n]), x_leaf[reads[n]],
                                  cfg, masks[n]) for n, p in layers.items()}
        names = list(layers)
        grads = torch.autograd.grad(
            [ys[n] for n in names], [s_leaf[n] for n in names]
            + [x_leaf[n] for n in widths], [dys[n] for n in names])
        out = {f"y.{n}": ys[n].detach() for n in names}
        out.update({f"ds.{n}": g for n, g in zip(names, grads)})
        out.update({f"dx.{n}": g for n, g in zip(widths, grads[len(names):])})
        return out

    def plain(fn):
        """fn() with the PTC kernels swapped for their plain versions."""
        with plain_kernels(torch, "blocked_lm"):
            return fn()

    def compare(got, want, tol, what):
        errs = {}
        for name in got:
            check(got[name].shape == want[name].shape
                  and got[name].dtype == want[name].dtype,
                  f"blocked_lm {what}: {name} shape or dtype differs from "
                  f"the plain step's")
            check(bool(torch.isfinite(got[name]).all()),
                  f"blocked_lm {what}: {name} is not finite")
            errs[name] = rel_err(got[name], want[name])[1]
            check(errs[name] < tol, f"blocked_lm {what}: {name} rel err "
                                    f"{errs[name]:.2e} >= {tol:g} against "
                                    f"the plain versions")
        return errs

    routes = WIDE_KERNELS + TC_KERNELS + TF32X3_KERNELS + NARROW_PTC
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = {k: build.launch_counts[k] for k in routes}
    print(f"[blocked_lm] step (7 forwards, 7 Σ-gradients, 7 feedbacks): "
          f"wall {1e3 * step_s:.1f} ms, first call; launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items()))
    for kernel in routes:
        want_n = len(OLMO_LINEARS) if kernel in TC_KERNELS else 0
        check(counts[kernel] == want_n,
              f"blocked_lm: {kernel} launched {counts[kernel]} times in the "
              f"bf16 step, not {want_n}")
    launches = {k: counts[k] for k in TC_KERNELS}
    warm_profile(torch, "bf16", step, (
        ("ptc_block_matmul_wide_tc", r"tc_(compose|product)_kernel"),
        ("sigma_grad_wide_tc", r"tc_(col_split|sigma)_kernel"),
        ("feedback_matmul_wide_tc", r"tc_(fcompose|feedback)_kernel")))

    # the same step through the plain versions, on the same masks
    want = plain(step)
    errs = compare(got, want, BLOCKED_LM_TOL, "bf16")
    # the column scale reaches ds in fp32: no bias against the plain step
    scales = {n: ls_scale(got[f"ds.{n}"], want[f"ds.{n}"])
              for n in layers}
    for n, sc in scales.items():
        check(abs(sc - 1) < 5e-4, f"blocked_lm: ds.{n} least-squares scale "
                                  f"{sc:.6f} against the plain step")
    print(f"[blocked_lm] kernels vs plain versions, same masks: max |err| "
          f"over the largest entry " + ", ".join(
              f"{n} {e:.1e}" for n, e in errs.items())
          + f" (tol 2^-7: one bf16 rounding of y, ds and dx); ds "
          f"least-squares scale within "
          f"{max(abs(sc - 1) for sc in scales.values()):.1e} of 1 (tol "
          f"5e-4)")
    del got, want

    # the same step with fp32 bases: the three in 3xTF32
    cfg32 = PTCLinearCfg(k=128, mode="blocked", base_dtype=torch.float32)
    layers32 = {n: dict(p, u=p["u"].float(), v=p["v"].float())
                for n, p in layers.items()}
    dys32 = {n: d.float() for n, d in dys.items()}
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step(layers32, cfg32, dys32)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = {k: build.launch_counts[k] for k in routes}
    for kernel in routes:
        want_n = len(OLMO_LINEARS) if kernel in TF32X3_KERNELS else 0
        check(counts[kernel] == want_n,
              f"blocked_lm: {kernel} launched {counts[kernel]} times in the "
              f"fp32 step, not {want_n}")
    # the CUDA-core routes: 0 on this path now
    launches.update({k: counts[k] for k in WIDE_KERNELS + TF32X3_KERNELS})
    want = plain(lambda: step(layers32, cfg32, dys32))
    errs = compare(got, want, 1e-4, "fp32")
    print(f"[blocked_lm] the same step with fp32 bases: wall "
          f"{1e3 * step_s:.1f} ms, first call; launches "
          + ", ".join(f"{k}={v}" for k, v in counts.items())
          + f"; kernels vs plain versions: max |err| over the largest entry "
          + ", ".join(f"{n} {e:.1e}" for n, e in errs.items())
          + " (tol 1e-4)")
    del got, want
    warm_profile(torch, "fp32", lambda: step(layers32, cfg32, dys32), (
        ("ptc_block_matmul_wide_3xtf32",
         r"x3_(split|compose)_kernel|x3_product_kernel<0>"),
        ("sigma_grad_wide_3xtf32",
         r"x3_tsplit_kernel|x3_product_kernel<(64|128)>"),
        ("feedback_matmul_wide_3xtf32",
         r"x3_(fsplit|fcompose|feedback)_kernel")))
    del layers32, dys32

    # realize the up projection's blocks: U and V* meshes of every block
    spec = un.mesh_spec(cfg.k, "reck")
    p, q = layers["up"]["s"].shape[:2]
    model = NoiseModel()
    real = sample_device(gen, (p * q,), cfg.k, model, kind="reck")
    phi = [torch.rand((p * q, spec.n_rot), generator=gen, device=dev)
           * 2 * torch.pi for _ in range(2)]
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, v = realized_unitaries(spec, phi[0], phi[1], real, model)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    mesh = {k: build.launch_counts[k] for k in (
        "mesh_apply", "mesh_apply_wide", "mesh_apply_wide_unrolled")}
    check(mesh == {"mesh_apply": 0, "mesh_apply_wide": 0,
                   "mesh_apply_wide_unrolled": 2},
          f"blocked_lm: the realization launched {mesh}, not the unrolled "
          f"wide mesh route twice")
    eye = torch.eye(cfg.k, device=dev)[None]
    err = 0.0
    for got_u, ph, noise, d in ((u, phi[0], real.noise_u, real.d_u),
                                (v, phi[1], real.noise_v, real.d_v)):
        want_u = mesh_apply_plain(spec, apply_phase_noise(spec, ph, noise,
                                                          model),
                                  eye, d, transpose_out=True)
        err = max(err, float((got_u - want_u).abs().max()))
    orth = float((u[0] @ u[0].T - eye[0]).abs().max())
    check(err < 1e-5, f"blocked_lm: realized unitaries max abs err "
                      f"{err:.2e} >= 1e-5 against the plain version")
    check(orth < 1e-4, f"blocked_lm: a realized U is not orthogonal "
                       f"({orth:.2e})")
    print(f"[blocked_lm] up projection realized: {2 * p * q} reck meshes "
          f"of k = {cfg.k} ({spec.n_rot} phases, {spec.n_layers} layers) in "
          f"{real_s * 1e3:.1f} ms wall, launches " + ", ".join(
              f"{n}={c}" for n, c in mesh.items())
          + f"; max abs err {err:.2e} against the plain version (tol "
          f"1e-5); U U^T - I {orth:.1e}")
    return dict(launches, mesh_apply_wide=mesh["mesh_apply_wide"],
                mesh_apply_wide_unrolled=mesh["mesh_apply_wide_unrolled"])


# ---------------------------------------------------------------------------
# phase 6: the LM serving gateway
# ---------------------------------------------------------------------------


def _leaves(tree):
    for leaf in tree.values():
        if isinstance(leaf, dict):
            yield from _leaves(leaf)
        else:
            yield leaf


# the checked gateway step, kernels against plain versions: the limit on
# max |error| over the largest entry, for logits and new KV rows; it must
# pass the sound step and fail the planted faults.  On an H100 the sound
# step read 1.25e-2 (new KV rows) and the mildest fault, a one-key mask
# leak, 6.78e-2 (new KV rows); the limit sits between them
GATEWAY_TOL = 3e-2


def card_params(torch, cfg, what: str) -> dict:
    """``cfg``'s seeded parameters made on the card; prints ``what`` (the
    shape), the init time, the size and the peak allocated memory."""
    from repro_torch.models import lm

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init_model(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[{cfg.name}] {what}, vocab {cfg.vocab}, PTC k={cfg.ptc.k} "
          f"{cfg.ptc.mode} {cfg.ptc.base_dtype}; init {init_s:.1f} s on the "
          f"card, parameters {n_bytes / 1e9:.2f} GB, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params


# qwen3-4b's depth in the gateway and serve phases: 9 of its 36 layers, to
# keep the whole script within half its time limit with the
# serving_gateway phase (the two phases took 73.4-89.2 s at 36 layers,
# 24.1-31.4 s at 9, on the H100; 15.1-23.8 s at 4, where the script ran
# while the e2e_accuracy phase's repairs were eager, 774.1-830.1 s in
# all).  Every layer has the same width, and the serving kernels' shapes
# a period are the full model's
QWEN_LAYERS = 9


def qwen3_4b_config():
    """qwen3-4b at full width, ``QWEN_LAYERS`` of its 36 layers."""
    import dataclasses
    from repro_torch.configs import get_config

    full = get_config("qwen3-4b")
    check((full.n_layers, full.d_model) == (36, 2560),
          f"qwen3-4b is {full}")
    return dataclasses.replace(full, n_layers=QWEN_LAYERS)


def qwen3_4b_params(torch) -> dict:
    """qwen3-4b's seeded parameters at full width, ``QWEN_LAYERS`` of its
    36 layers, made on the card (for the gateway and serve phases)."""
    cfg = qwen3_4b_config()
    return card_params(torch, cfg, (
        f"{cfg.n_layers} of 36 layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, d_ff "
        f"{cfg.d_ff}"))


def staged_qwen3_4b_params(torch) -> dict:
    """``qwen3_4b_params`` made while the kernels build (its init runs
    cuSOLVER's QRs on the card and no kernel of the port), then held in
    pinned host memory until the gateway phase, so that the phases between
    see the card's memory as they did."""
    from repro_torch.models.layers import tree_map

    params = qwen3_4b_params(torch)
    t0 = time.perf_counter()
    host = tree_map(lambda t: torch.empty(
        t.shape, dtype=t.dtype, pin_memory=True).copy_(t), params)
    del params
    torch.cuda.empty_cache()
    print(f"[qwen3-4b] made while the kernels build; held in pinned host "
          f"memory until the gateway phase ({time.perf_counter() - t0:.1f} "
          f"s to copy)")
    return host


def gateway_phase(torch, params, check_step: int = 12) -> dict:
    """qwen3-4b at full width (k = 128 fused PTC, bf16 bases; ``params``
    from :func:`qwen3_4b_params`) served through the gateway with chunked
    prefill; returns the launches of the three serving kernels over that
    run.

    Busy step ``check_step`` is also checked: its gathered views and its
    scattered pools bitwise against the plain versions, and (after the
    run) its logits and new KV rows against the same step with the
    attention through the plain version, and through planted faults of it
    that the limit must catch."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import build, paged_scatter, ref
    from repro_torch.kernels.prefill_attn import NAME_CUDA_CORES as NAME_CC
    from repro_torch.models import attention, lm
    from repro_torch.serving import (GatewayConfig, PageConfig,
                                     ServingGateway, poisson_workload)

    dev = torch.device("cuda")
    cfg = qwen3_4b_config()

    pages = PageConfig(page_size=16, n_pages=320, max_pages_per_slot=40)
    gcfg = GatewayConfig(slots=8, pages=pages, prefill_chunk=64, kv_block=64)
    reqs = poisson_workload(0, 16, 0.5, cfg.vocab, prompt_len=(128, 512),
                            max_new=(16, 64))
    # warm-up, untimed: build the serving kernels (if the kernels phase
    # did not), and let cuBLAS and the allocator meet every shape
    t0 = time.perf_counter()
    build.build([build.KERNELS[k] for k in GATEWAY_KERNELS])
    ServingGateway(cfg, params, gcfg, device=dev).run(poisson_workload(
        1, 2, 1.0, cfg.vocab, prompt_len=(64, 128), max_new=(2, 2)))
    torch.cuda.synchronize()
    print(f"[gateway] warm-up (kernel build if needed, 2 short requests): "
          f"{time.perf_counter() - t0:.1f} s")
    gw = ServingGateway(cfg, params, gcfg, device=dev)
    print(f"[gateway] {len(reqs)} requests at 0.5 per step, prompts "
          f"{min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)} tokens, max_new "
          f"{min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}, "
          f"no EOS; {gcfg.slots} slots, pages of {pages.page_size} x "
          f"{pages.n_pages} (+1 scratch) per period, S_max "
          f"{pages.max_tokens_per_slot}, prefill chunk {gcfg.prefill_chunk},"
          f" kv block {gcfg.kv_block}")

    # instrument the run: a mark (host clock, launch counts) at the start
    # of every busy step (its gather), and the checks of one busy step
    marks, captured = [], {}
    gather, step_fn, scatter = gw._gather_views, gw._step_fn, gw._scatter

    def gather_views():
        marks.append((time.perf_counter(), dict(build.launch_counts)))
        views = gather()
        if len(marks) == check_step:
            table = torch.as_tensor(gw._period_table(), device=dev)
            for name, pools in gw._pools.items():
                for kk, pool in pools.items():
                    want = ref.paged_gather_ref(table, pool)
                    check(torch.equal(views[name][kk].reshape(want.shape),
                                      want),
                          f"gateway step {check_step}: gathered {name}.{kk} "
                          f"differs from the plain version")
        return views

    def step(prm, views, batch):
        out = step_fn(prm, views, batch)
        if len(marks) == check_step:
            captured.update(views=views, batch=batch, out=out)
        return out

    def scatter_rows(new_kv, full_idx, fn):
        if len(marks) != check_step:
            return scatter(new_kv, full_idx, fn)
        before = {n: {kk: t.clone() for kk, t in p.items()}
                  for n, p in gw._pools.items()}
        scatter(new_kv, full_idx, fn)
        after, gw._pools = gw._pools, before
        scatter(new_kv, full_idx, ref.paged_scatter_ref)
        plain, gw._pools = gw._pools, after
        for name in after:
            for kk in after[name]:
                check(torch.equal(after[name][kk], plain[name][kk]),
                      f"gateway step {check_step}: scattered {name}.{kk} "
                      f"differs from the last-wins plain version")
        captured["idx"] = full_idx

    gw._gather_views, gw._step_fn, gw._scatter = \
        gather_views, step, scatter_rows
    build.reset_launch_counts()
    rep = gw.run(reqs)
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), dict(build.launch_counts)))
    launches = {k: build.launch_counts[k] for k in GATEWAY_KERNELS}
    del gw._gather_views, gw._scatter                # back to the methods
    gw._step_fn = step_fn

    step_ms = []
    for i, ((t_a, c_a), (t_b, c_b)) in enumerate(zip(marks, marks[1:]), 1):
        for kernel in GATEWAY_KERNELS:
            check(c_b[kernel] > c_a[kernel],
                  f"gateway: {kernel} not launched in busy step {i}")
        # bf16 pools at Dh 128: every layer's prefill on the tensor cores
        tc = c_b["prefill_attention"] - c_a["prefill_attention"]
        cc = c_b[NAME_CC] - c_a[NAME_CC]
        check(tc == cfg.n_layers and cc == 0,
              f"gateway: busy step {i} made {tc} tensor-core and {cc} "
              f"CUDA-core prefill launches, not {cfg.n_layers} and 0")
        if i != check_step:
            step_ms.append(1e3 * (t_b - t_a))
    per_step = {k: (marks[1][1][k] - marks[0][1][k])
                for k in (*GATEWAY_KERNELS, NAME_CC)}
    for r in rep["requests"]:
        check(r["n_out"] == r["max_new"] and r["finish_reason"] == "max_new",
              f"gateway: request {r['rid']} produced {r['n_out']} of "
              f"{r['max_new']} tokens")
    lat, ttft = rep["latency_steps"], rep["ttft_steps"]
    median_ms = float(np.median(step_ms))
    print(f"[gateway] served {len(rep['requests'])} requests: "
          f"{rep['steps']} steps ({rep['busy_steps']} busy, occupancy "
          f"{rep['occupancy']:.2f}/{gcfg.slots}), {rep['tokens_out']} tokens "
          f"out in {rep['wall_s']:.2f} s wall ({rep['tokens_per_s']:.1f} "
          f"tokens/s); TTFT steps p50 {ttft['p50']:.0f} p99 {ttft['p99']:.1f};"
          f" latency steps p50 {lat['p50']:.0f} p99 {lat['p99']:.1f}")
    print(f"[gateway] busy step (gather, forward, scatter, argmax to the "
          f"host) median {median_ms:.2f} ms, min {min(step_ms):.2f}, max "
          f"{max(step_ms):.2f} over {len(step_ms)} steps; launches per busy "
          f"step " + ", ".join(f"{k}={v}" for k, v in per_step.items())
          + "; over the run " + ", ".join(f"{k}={v}" for k, v in
                                           launches.items())
          + f"; peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB")

    # the checked step again with the attention through the plain version,
    # and through planted faults of it, each of which must read above the
    # limit: GQA's head map as `.repeat` (head h reads KV head h % Hkv
    # instead of h // rep), the 1/sqrt(Dh) logit scale dropped, and the
    # causal mask one key too wide (query c also sees key lens + c + 1)
    kernel = attention.prefill_attention
    logits_k, new_k = captured["out"]

    def plain_step(fault=None):
        def plain_attention(lens, q, k, v, *, blk=None, window=None,
                            cap=None):
            if fault == "mask":
                lens = lens + 1
            elif fault == "scale":
                q = q * q.shape[-1] ** 0.5
            elif fault == "gqa":
                rep = q.shape[2] // k.shape[2]
                k, v = k.repeat(1, 1, rep, 1), v.repeat(1, 1, rep, 1)
            return ref.prefill_attention_ref(lens, q, k, v, window=window,
                                             cap=cap)
        attention.prefill_attention = plain_attention
        try:
            logits, new = gw._step_fn(params, captured["views"],
                                      captured["batch"])
        finally:
            attention.prefill_attention = kernel
        rel_kv = max(rel_err(new_k["pos0"][kk], new["pos0"][kk])[1]
                     for kk in ("k", "v"))
        return rel_err(logits_k, logits)[1], rel_kv, logits, new

    rel_logits, rel_kv, logits_p, new_p = plain_step()
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    first_equal = all(torch.equal(new_k["pos0"][kk][0], new_p["pos0"][kk][0])
                      for kk in ("k", "v"))
    del logits_p, new_p
    check(first_equal, "gateway: layer 0's new KV rows differ between the "
                       "kernel and plain steps (they precede any attention)")
    check(rel_logits < GATEWAY_TOL and rel_kv < GATEWAY_TOL,
          f"gateway step {check_step}: kernel vs plain attention: logits "
          f"rel err {rel_logits:.2e}, new KV rel err {rel_kv:.2e} (tol "
          f"{GATEWAY_TOL:.0e})")
    faults = {f: plain_step(f)[:2] for f in ("gqa", "scale", "mask")}
    print(f"[gateway] busy step {check_step}, kernels vs plain versions on "
          f"the same views: gathered views and scattered pools bitwise equal;"
          f" logits rel err {rel_logits:.2e}, new KV rows rel err "
          f"{rel_kv:.2e} (tol {GATEWAY_TOL:.0e} of the largest entry: bf16 "
          f"through {cfg.n_layers} layers), layer 0's rows bitwise equal, argmax agrees "
          f"on {agree:.2f} of the slots; planted faults in the plain version "
          + ", ".join(f"{f}: logits {a:.2e}, new KV {b:.2e}"
                      for f, (a, b) in faults.items()))
    for f, (a, b) in faults.items():
        check(max(a, b) > GATEWAY_TOL,
              f"gateway step {check_step}: planted fault '{f}' reads logits "
              f"{a:.2e}, new KV {b:.2e}, inside the limit {GATEWAY_TOL:.0e}")

    # where a busy step's device time goes: the checked step replayed
    # (gather, forward, scatter, argmax) 5 times unprofiled, 5 profiled
    def busy_step():
        views = gw._gather_views()
        logits, new_kv = gw._step_fn(params, views, captured["batch"])
        gw._scatter(new_kv, captured["idx"], paged_scatter)
        return logits.argmax(-1).cpu()

    busy_step()
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        busy_step()
        wall.append(1e3 * (time.perf_counter() - t0))
    replay_ms = float(np.median(wall))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            busy_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 5e3
    if busy_ms == 0:
        print("[profile] gateway: the profiler saw no device time; not "
              "measured")
    else:
        print(f"[profile] gateway busy step replayed 5 times: unprofiled "
              f"median {replay_ms:.2f} ms, kernel time {busy_ms:.2f} ms/step "
              f"in {sum(e.count for e in kernels) / 5:.0f} launches/step: "
              f"device busy {100 * busy_ms / replay_ms:.0f}%")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        print("[profile] top device operations per step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms x"
            f"{e.count / 5:.0f}" for e in top))
    del gw, captured
    torch.cuda.empty_cache()

    # smoke width, fp32, on the card: chunked prefill emits the one-token
    # path's tokens (gemma2: sliding window and soft-caps in the kernel);
    # fp32 attention takes the CUDA-core route, whose launches here are its
    # count on a main path
    build.reset_launch_counts()
    for name in ("qwen3-4b", "gemma2-27b"):
        scfg = smoke_config(name)
        sp = lm.init_model(torch.Generator(dev).manual_seed(1), scfg)
        tokens = {}
        for chunk in (1, 8):
            g = ServingGateway(scfg, sp, GatewayConfig(
                slots=4, pages=PageConfig(8, 64, 8), prefill_chunk=chunk,
                kv_block=8 if chunk > 1 else None), device=dev)
            r = g.run(poisson_workload(1, 8, 0.5, scfg.vocab,
                                       prompt_len=(4, 40), max_new=(4, 16)))
            tokens[chunk] = [q["tokens"] for q in r["requests"]]
        n = sum(len(t) for t in tokens[1])
        check(tokens[1] == tokens[8], f"gateway {scfg.name}: chunk 8 tokens "
                                      f"differ from chunk 1 tokens")
        print(f"[gateway] {scfg.name} (fp32): prefill chunk 8 emits the "
              f"chunk-1 path's {n} tokens of 8 requests exactly")
    check(build.launch_counts[NAME_CC] > 0
          and build.launch_counts["prefill_attention"] == 0,
          "gateway: the fp32 smoke-width gateways did not take the "
          "CUDA-core prefill route alone")
    print(f"[gateway] smoke-width fp32 gateways: {NAME_CC} launched "
          f"{build.launch_counts[NAME_CC]} times")
    return dict(launches, **{NAME_CC: build.launch_counts[NAME_CC]})


# ---------------------------------------------------------------------------
# phase 8: the paper's tables
# ---------------------------------------------------------------------------

# the kernels the tables' path launches: the IC and PM probes (the narrow
# mesh and the per-block forward), Fig. 8's blocked layer (the product
# forward, the Σ-gradient and the feedback)
TABLE_KERNELS = QUICKSTART_KERNELS
# the reference's rows at each budget on a CPU (`PYTHONPATH=src python -m
# benchmarks.run --budget B --only NAME`, JAX 0.9.0), printed beside the
# card's ZO tables: Fig. 4 (method: final loss, identity MSE), Fig. 5
# (method: err_init, err_after_zo, err_after_osp), Table 4 (k: IC MSE),
# Table 5 (k: accuracy %), and Table 3 (k: rel_err) beside its card rows
REFERENCE_TABLES = {
    "quick": dict(
        fig4={"zgd": (0.04504, 0.1091), "zcd": (0.02246, 0.0807),
              "ztp": (0.00849, 0.0599)},
        fig5={"zgd": (0.03588, 0.00096, 0.00096),
              "zcd": (0.03588, 0.0322, 0.03184),
              "ztp": (0.03588, 0.00631, 0.00628)},
        t3={8: 0.0752, 9: 0.0817, 12: 0.0942, 16: 0.1046},
        t4={8: 0.0487, 9: 0.0326, 12: 0.0537, 16: 0.0398},
        t5={8: 100.0, 9: 100.0, 12: 99.61, 16: 99.02}),
    "normal": dict(
        fig4={"zgd": (0.02515, 0.1047), "zcd": (0.01616, 0.0811),
              "ztp": (0.00596, 0.0519)},
        fig5={"zgd": (0.03588, 0.0008, 0.0008),
              "zcd": (0.03588, 0.0322, 0.03184),
              "ztp": (0.03588, 0.00388, 0.00387)},
        t3={8: 0.0752, 9: 0.0817, 12: 0.0942, 16: 0.1046, 24: 0.1315,
            32: 0.135},
        t4={8: 0.0713, 9: 0.0098, 12: 0.0313, 16: 0.0368, 24: 0.0211,
            32: 0.0269},
        t5={8: 100.0, 9: 100.0, 12: 99.8, 16: 99.61, 24: 98.83,
            32: 97.27}),
}
# the ZO tables' limits (the port draws its own randomness, so it lands
# near the reference's rows, not on them): every IC identity MSE of Fig. 4
# under 0.15 and of Table 4 under 0.1 (the reference's worst rows 0.1091
# and 0.0713); Fig. 5's err_init in (0.02, 0.06), err_osp <= err_zo <=
# err_init, and ZGD's and ZTP's err_osp under a quarter of err_init (the
# reference's 0.0008 and 0.0039 against 0.0359); every Table 5 accuracy
# at least 95% (the reference's worst 97.27)
TABLE_LIMITS = dict(fig4_mse=0.15, t4_mse=0.1, fig5_init=(0.02, 0.06),
                    fig5_drop=0.25, t5_acc=95.0)
# the deterministic tables against the same tables with the kernels
# swapped for their plain versions, on the card, on the same draws: the
# largest difference of a Fig. 8 metric, and Table 3's relative difference
TABLE_TOL = 1e-4


@contextlib.contextmanager
def plain_kernels(torch, what: str):
    """The k <= 32 PTC kernels and the mesh swapped for their plain
    versions where the port calls them (the twin's probes, the realized
    meshes, the blocked layer); checks that ``what`` launched nothing."""
    from repro_torch.core import ptc, subspace, unitary
    from repro_torch.hw import jobs, twin
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.mesh_apply import mesh_apply_plain

    swaps = [(m, "ptc_block_matmul", ref.ptc_block_matmul_ref)
             for m in (jobs, twin, ptc, subspace)]
    swaps += [(subspace, "sigma_grad", ref.sigma_grad_ref),
              (subspace, "feedback_matmul", ref.feedback_matmul_ref),
              (unitary, "mesh_apply_batched", mesh_apply_plain)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    before = dict(build.launch_counts)
    for m, name, fn in swaps:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    torch.cuda.synchronize()
    check(build.launch_counts == before,
          f"{what}: the plain versions launched a kernel")


def tables_phase(torch, budget: str) -> dict:
    """The six paper benchmarks through ``repro_torch.benchmarks.run`` on
    the card, with every launch count set to 0 just before and read just
    after; returns those counts."""
    from repro_torch.benchmarks import (blocksize_tables as bt,
                                        grad_fidelity as gf, ic_convergence,
                                        mapping_osp, run)
    from repro_torch.benchmarks.common import cpu_generator, to_device
    from repro_torch.core.calibration import calibrate_identity
    from repro_torch.core.noise import NoiseModel
    from repro_torch.kernels import build

    import functools

    dev = torch.device("cuda")
    build.build([build.KERNELS[k] for k in TABLE_KERNELS])
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    benches = run.TABLES
    if budget == "quick":
        benches = tuple(
            (name, functools.partial(fn, t4_ks=TABLE4_KS)
             if name == "tables345_blocksize" else fn)
            for name, fn in benches)
        print(f"[tables] Table 4 at k = {', '.join(map(str, TABLE4_KS))} of "
              f"{', '.join(map(str, bt.block_sizes(budget)))} (cut to keep "
              f"the script within half its time limit)")
    recs = run.run(budget, device=dev, benches=benches)
    wall = time.perf_counter() - t0
    launches = {k: build.launch_counts[k] for k in TABLE_KERNELS}
    other = {k: v for k, v in build.launch_counts.items()
             if v and k not in TABLE_KERNELS}
    print(f"[tables] budget {budget}: six benchmarks in {wall:.1f} s of host "
          f"wall (the card synchronized at each end); launches "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + (f"; other kernels {other}" if other else "; no other kernel"))
    for rec in recs:           # (the runner printed each table's rows)
        print(f"[tables] {rec['name']}: {rec['seconds']:.2f} s, launches "
              + (", ".join(f"{k}={v}" for k, v in rec["launches"].items())
                 or "none (the cost model only)"))
    for kernel, n in launches.items():
        check(n > 0, f"tables: {kernel} was not launched on the path")
    check(not other, f"tables: launched kernels off its path: {other}")
    tables = {name: rows for rec in recs for name, rows in
              rec["tables"].items()}
    refs = REFERENCE_TABLES[budget]

    # the deterministic tables against their plain versions, same draws
    d = to_device(gf.draw(cpu_generator(0), gf.n_mc(budget)), dev)
    card = gf.fig8ab(d) + gf.fig8cd(d)
    with plain_kernels(torch, "tables"):
        plain = gf.fig8ab(d) + gf.fig8cd(d)
    fig8_err = max(abs(a - b) for rk, rp in zip(card, plain)
                   for a, b in zip(rk[-2:], rp[-2:]))
    check(fig8_err <= TABLE_TOL, f"tables: Fig. 8 kernels vs plain versions "
                                 f"differ by {fig8_err:.2e} > {TABLE_TOL}")
    ks = bt.block_sizes(budget)
    devs = to_device(bt.draw_t3(cpu_generator(0), ks), dev)
    w = bt.t3_weight().to(dev)
    t3 = bt.table3(w, devs, dev)
    with plain_kernels(torch, "tables"):
        t3_plain = bt.table3(w, devs, dev)
    t3_err = max(abs(a[1] - b[1]) / b[1] for a, b in zip(t3, t3_plain))
    check(t3_err <= TABLE_TOL, f"tables: Table 3 kernels vs plain versions "
                               f"differ by {t3_err:.2e} (relative) > "
                               f"{TABLE_TOL}")
    print(f"[tables] Fig. 8 (a)-(d) recomputed on the same draws, kernels vs "
          f"plain versions on the card: largest metric difference "
          f"{fig8_err:.2e} (tol {TABLE_TOL:.0e}); Table 3 rel_err relative "
          f"difference {t3_err:.2e} (tol {TABLE_TOL:.0e}); Table 3 rows "
          + ", ".join(f"k {k} {e:.4f} (reference CPU {refs['t3'][k]})"
                      for k, e, _ in t3))
    check(tables["table2_vgg8"] and tables["table2_resnet18"]
          and tables["fig10_scalability"], "tables: a cost-model table is "
                                           "empty")

    # the ZO tables by their result metrics, beside the reference's rows
    lim = TABLE_LIMITS
    for method, loss, mse, _ in tables["fig4_ic_convergence"]:
        ref_loss, ref_mse = refs["fig4"][method]
        print(f"[tables] Fig. 4 {method}: loss {loss} identity MSE {mse} "
              f"(reference CPU {ref_loss}, {ref_mse}; limit MSE < "
              f"{lim['fig4_mse']})")
        check(mse < lim["fig4_mse"], f"tables: Fig. 4 {method} MSE {mse}")
    for method, init, zo, osp in tables["fig5_mapping_osp"]:
        print(f"[tables] Fig. 5 {method}: err_init {init}, err_zo {zo}, "
              f"err_osp {osp} (reference CPU {refs['fig5'][method]})")
        check(lim["fig5_init"][0] < init < lim["fig5_init"][1]
              and osp <= zo * (1 + 1e-3) and zo <= init * (1 + 1e-3),
              f"tables: Fig. 5 {method}: err_init {init}, err_zo {zo}, "
              f"err_osp {osp}")
        if method != "zcd":
            check(osp < lim["fig5_drop"] * init,
                  f"tables: Fig. 5 {method} err_osp {osp} not under "
                  f"{lim['fig5_drop']} of err_init {init}")
    for k, mse, _ in tables["table4_ic_mse_vs_k"]:
        check(mse < lim["t4_mse"], f"tables: Table 4 k {k} MSE {mse}")
    for k, acc, _, _ in tables["table5_subspace_acc_vs_k"]:
        check(acc >= lim["t5_acc"], f"tables: Table 5 k {k} accuracy {acc}")
    print("[tables] Table 4 IC MSE by k: " + ", ".join(
        f"{k} {m} (reference CPU {refs['t4'][k]})"
        for k, m, _ in tables["table4_ic_mse_vs_k"])
        + f"; limit < {lim['t4_mse']}")
    print("[tables] Table 5 accuracy % by k: " + ", ".join(
        f"{k} {a} (reference CPU {refs['t5'][k]})"
        for k, a, _, _ in tables["table5_subspace_acc_vs_k"])
        + f"; limit >= {lim['t5_acc']}")

    # where the phase's time goes: a profiled slice of each kind of work
    gen = cpu_generator(1)
    ic_draws = to_device(ic_convergence.draw(
        gen, ic_convergence.zo_config("quick")._replace(steps=50),
        NoiseModel()), dev)
    cfg_ic = ic_convergence.zo_config("quick")._replace(steps=50)
    cfg_pm = mapping_osp.zo_config("quick")._replace(steps=50)
    pm_draws = to_device(mapping_osp.draw(gen, cfg_pm,
                                          mapping_osp.harsh_model()), dev)
    cfg_t4 = {32: bt.t4_config(32, "quick")._replace(steps=50)}
    t4_draws = to_device(bt.draw_t4(gen, cfg_t4, restarts=1), dev)
    d2 = to_device(gf.draw(cpu_generator(0), 2), dev)
    t5p = to_device(bt.draw_t5(gen, [9]), dev)[9]
    x5, y5 = (torch.as_tensor(a, device=dev) for a in bt.t5_data()[:2])
    slices = {
        "fig4_ic_convergence": ("50 ZCD steps, k 9, 4 blocks", 50,
                                lambda: calibrate_identity(
                                    None, 4, 9, NoiseModel(), cfg=cfg_ic,
                                    dev=ic_draws["dev"], restarts=1,
                                    device=dev,
                                    draws=ic_draws["zcd"][:1])),
        "fig5_mapping_osp": ("50 ZTP steps, k 9, 9 blocks", 50,
                             lambda: mapping_osp.fig5(
                                 mapping_osp.weight().to(dev), pm_draws,
                                 cfg_pm, mapping_osp.harsh_model(), dev)),
        "tables345_blocksize": ("50 ZCD steps, k 32, 4 blocks", 50,
                                lambda: bt.table4(t4_draws, cfg_t4, dev)),
        "fig8_grad_fidelity": ("2 samples of the 22 configurations", 44,
                               lambda: (gf.fig8ab(d2), gf.fig8cd(d2))),
        "table5": ("10 AdamW steps, k 9", 10,
                   lambda: bt.train_sigma(*t5p, x5, y5, 10)),
    }
    shares = {}
    for name, (what, units, job) in slices.items():
        got = busy_share(torch, job)
        if got is None:
            print(f"[profile] tables {name}: the profiler saw no device "
                  f"time; busy share not measured")
            continue
        wall_ms, busy_ms, n, _ = got
        if name == "fig5_mapping_osp":     # three methods per call
            units *= 3
        shares[name] = busy_ms / wall_ms
        print(f"[profile] tables {name}, {what}: host wall {wall_ms:.1f} ms "
              f"({wall_ms / units:.3f} ms a unit), kernel time "
              f"{busy_ms:.2f} ms in {n} launches ({n / units:.0f} a unit): "
              f"device busy {100 * busy_ms / wall_ms:.0f}%")
    secs = {rec["name"]: rec["seconds"] for rec in recs}
    if all(name in shares for name in secs if name in slices):
        busy = sum(secs[n] * shares[n] for n in secs if n in shares)
        print(f"[profile] tables phase: device busy about "
              f"{100 * busy / sum(secs.values()):.0f}% of its wall "
              f"(each benchmark's wall times its slice's share; "
              f"tables345 by its Table 4 slice, the cost-model tables idle)")
    return launches


# ---------------------------------------------------------------------------
# phase 7: solo serving
# ---------------------------------------------------------------------------

# the solo path's last-prompt logits against the gateway's for the same
# prompt: the gateway phase's limit (set for bf16 through all 36 layers)
SERVE_TOL = 3e-2


def serve_phase(torch, params) -> None:
    """``repro_torch.launch.serve.run`` at qwen3-4b full width (bf16 bases,
    batch 4, prompt 64, 32 new tokens) timed; its last-prompt logits held
    against the gateway's for the same prompts; at smoke width in fp32 its
    tokens equal to the gateway's for every request."""
    import argparse
    import numpy as np
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import greedy_decode
    from repro_torch.models import lm
    from repro_torch.serving import (GatewayConfig, PageConfig, Request,
                                     ServingGateway, poisson_workload)

    dev = torch.device("cuda")
    cfg = qwen3_4b_config()
    batch, plen, gen = 4, 64, 32
    args = argparse.Namespace(arch=cfg, batch=batch, prompt_len=plen,
                              gen=gen, seed=0, device=dev,
                              params_override=params)
    t0 = time.perf_counter()
    # warm-up: a step has the same shapes at every position (one token
    # against the dense cache), so a short prompt meets them all
    serve.run(argparse.Namespace(**{**vars(args), "prompt_len": 8,
                                    "gen": 2}))
    print(f"[serve] warm-up (prompt 8, 2 new tokens): "
          f"{time.perf_counter() - t0:.1f} s")
    out = serve.run(args)
    steps = plen + gen - 1
    check(out["gen"].shape == (batch, gen)
          and bool(((out["gen"] >= 0) & (out["gen"] < cfg.vocab)).all()),
          "serve: bad generated tokens")
    print(f"[serve] qwen3-4b full width ({cfg.ptc.mode} PTC, k "
          f"{cfg.ptc.k}, {cfg.ptc.base_dtype}), batch {batch}, prompt "
          f"{plen}, {gen} new tokens: {out['gen'].size} tokens in "
          f"{out['wall_s']:.2f} s of wall ({out['tokens_per_s']:.1f} "
          f"tokens/s), {steps} steps, {1e3 * out['wall_s'] / steps:.1f} ms "
          f"a step; {card_line()}")

    # the gateway on the same prompts: its first busy step ingests each
    # whole prompt (chunk 64), so its logits are the last prompt position's
    prompts = lm_batch(0, 0, batch, plen, cfg.vocab)["tokens"]
    gw = ServingGateway(cfg, params, GatewayConfig(
        slots=batch, pages=PageConfig(16, 8 * batch, 8), prefill_chunk=plen,
        kv_block=64), device=dev)
    first, step_fn = [], gw._step_fn

    def step(prm, views, b):
        res = step_fn(prm, views, b)
        if not first:
            first.append(res[0].float())
        return res

    gw._step_fn = step
    rep = gw.run([Request(rid=i, prompt=prompts[i], max_new=gen)
                  for i in range(batch)])
    gw_logits = first[0]
    gw_tokens = np.asarray([r["tokens"] for r in rep["requests"]])
    check(bool((gw_tokens[:, 0] == gw_logits.argmax(-1).cpu().numpy())
               .all()), "serve: the gateway's slots are not its requests")
    trace = []
    greedy_decode(lm.build_serve_step(cfg), params,
                  lm.init_decode_cache(cfg, batch, plen + 1, device=dev),
                  prompts, 1, logits_out=trace)
    solo = torch.as_tensor(trace[-1], device=dev)
    _, rel = rel_err(solo, gw_logits)
    same = float((out["gen"] == gw_tokens).mean())
    check(rel < SERVE_TOL, f"serve: solo vs gateway last-prompt logits rel "
                           f"err {rel:.2e} >= {SERVE_TOL}")
    print(f"[serve] solo vs gateway (chunked prefill, the prefill kernel) "
          f"on the same prompts: last-prompt logits within {rel:.2e} of the "
          f"largest (tol {SERVE_TOL:.0e}); {100 * same:.1f}% of the "
          f"{gw_tokens.size} generated tokens identical")
    del gw, first, solo, trace

    # smoke width, fp32: each request served alone emits the gateway's
    # tokens (the check of tests/test_serving_gateway.py)
    scfg = smoke_config("qwen3-4b")
    sp = lm.init_model(torch.Generator(dev).manual_seed(1), scfg)
    for chunk in (1, 8):
        # fresh requests: the gateway fills each one's out_tokens
        reqs = poisson_workload(1, 8, 0.5, scfg.vocab, prompt_len=(4, 40),
                                max_new=(4, 16))
        rep = ServingGateway(scfg, sp, GatewayConfig(
            slots=4, pages=PageConfig(8, 64, 8), prefill_chunk=chunk,
            kv_block=8 if chunk > 1 else None), device=dev).run(reqs)
        for r, got in zip(reqs, rep["requests"]):
            solo = serve.run(argparse.Namespace(
                arch=scfg, batch=1, prompt_len=r.prompt_len, gen=r.max_new,
                seed=0, device=dev, params_override=sp,
                prompt_tokens=np.asarray(r.prompt)[None]))
            check([int(t) for t in solo["gen"][0]] == got["tokens"],
                  f"serve {scfg.name}: request {r.rid} alone differs from "
                  f"the gateway at chunk {chunk}")
    print(f"[serve] {scfg.name} (fp32): each of 8 requests served alone "
          f"emits the gateway's tokens exactly, at prefill chunk 1 and 8")


# ---------------------------------------------------------------------------
# phase 8: the ssm, hybrid and MoE families
# ---------------------------------------------------------------------------

# the chunked scan against 64 steps of the one-token recurrence at one
# falcon-mamba-7b layer (bf16 bases, k = 128): the limit on max |error|
# over the largest entry of the output, of the last h and of the conv
# rows.  Set from CPU runs of the same check at k = 128, bf16, 64 tokens,
# d_model 512 and 1024: the output read up to 3.9e-3 and h 1.1e-3 (bf16
# products round differently over 64 rows and over one); the reference's
# own decode-against-prefill test allows 2e-2 (tests/test_arch_smoke.py)
SCAN_TOL = 2e-2
# one qwen3-moe-30b-a3b layer's dispatch at decode (nothing dropped)
# against the dense combine of each token's top-k experts: bf16 expert
# outputs gate-weighted and summed in bf16, against an fp32 sum
MOE_TOL = 2e-2
# the smoke-width configs (fp32) stepped on the card and on the CPU from
# one decode state, kept in fp32: their logits.  With the bf16 state the
# serving paths keep, a rounding tie of a new K/V or conv row taken the
# other way moves the logits by more than the arithmetic does: on the
# H100, moonshot's smoke config read 3.02e-4 stepped from one bf16 state
# and 2.50e-4 run free, qwen3-moe's 5.11e-7 and 4.05e-7
FAMILY_SMOKE_TOL = 1e-4


def serve_step_profile(torch, cfg, params, batch: int) -> None:
    """One solo serve step at cache position 31, warm: its wall, its
    device time by kernel from ``torch.profiler`` over 3 steps, the busy
    share and the three largest kernels."""
    from repro_torch.models import lm

    dev = torch.device("cuda")
    step = lm.build_serve_step(cfg)
    cache = lm.init_decode_cache(cfg, batch, 64, device=dev)
    b = {"token": torch.zeros((batch, 1), dtype=torch.int64, device=dev),
         "cache_len": 31}

    def run():
        step(params, cache, b)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    split = sorted(device_split(run, 3), key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms in split)
    print(f"[{cfg.name}] one solo step, warm: wall {wall_ms:.1f} ms, "
          f"{busy_ms:.2f} ms of kernels (busy {100 * busy_ms / wall_ms:.0f}%)"
          f"; largest: " + ", ".join(f"{name[:48]} {ms:.2f}"
                                     for name, ms in split[:3]))


# the depth of three earlier paths, cut as phases were added to keep the
# whole script near half its time limit.  falcon-mamba-7b's 64 layers took
# 70-100 s to seed and most of the families phase's 162-170 s on the H100;
# with the train phase added, 32 of them kept the script at 586-600 s,
# with the closed loop 16 did (568.7 s), and with the hw_serve phase (75.1
# s) the script read 656.5 s on a host that ran the tables 41% slower than
# the run before, so falcon-mamba-7b kept 8 layers, qwen3-moe-30b-a3b 2 of
# 48 (4 before) and llama-3.2-vision-11b one period of 5 layers, one with
# cross-attention (2 periods before).  With the driver phase (144.1 s) the
# script read 658.6 s, then 622.8 s with falcon-mamba-7b at 4 layers and
# qwen3-moe-30b-a3b at 1, so falcon-mamba-7b keeps 2.  Every layer of a
# model has the same width and block grids.  With the remat policies and
# the examples phase added, two sizes were cut: at --budget quick the
# tables phase runs Table 4 (IC MSE by k) at k = 8 and 9 of its 8, 9, 12,
# 16 (its rows there are the full table's, every draw made as for all four;
# k = 12 and 16 are 18,600 of its 25,000 ZCD steps, about 65 s on the
# H100), and the driver phase times each driver_overhead sweep as the
# median of 3 repeats, not 5 (each repeat at least 0.25 s: about 8 s a
# repeat).  The median of 2 is the mean of both, so one stalled sample
# moves the throughput gate (0.42-0.99 against 0.5 with 2 repeats on the
# H100, 0.47-1.06 with 3).  One restart of Table 4 instead of four would
# save as much but read IC MSEs of 0.08-0.11 on a CPU run, against the
# limit 0.1
FALCON_LAYERS = 2
MOE_LAYERS = 1
VLM_PERIODS = 1
TABLE4_KS = (8, 9)
DRIVER_OVERHEAD_REPEATS = 3


def falcon_mamba_phase(torch) -> None:
    """falcon-mamba-7b at full width (bf16 bases, k = 128) with its depth
    cut to 2 of 64 layers (``FALCON_LAYERS``), seeded on the card: the
    solo serve path (batch 4, prompt 32, 32 new tokens) and the gateway
    (8 slots, prefill chunk 1, 8 Poisson requests) timed; the gateway's
    last-prompt logits against the solo path's; one layer's chunked scan
    against its one-token recurrence."""
    import argparse
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import layers, ssm
    from repro_torch.serving import (GatewayConfig, PageConfig, Request,
                                     ServingGateway, poisson_workload)

    dev = torch.device("cuda")
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=FALCON_LAYERS)
    sc = cfg.ssm_cfg()
    params = card_params(torch, cfg, (
        f"{cfg.n_layers} of {full.n_layers} mamba layers, d_model "
        f"{cfg.d_model}, d_inner "
        f"{sc.d_inner}, state {sc.d_state}, dt rank {sc.rank}"))
    layer = params["pos0"]["mamba"]
    grids = {n: tuple(layer[n]["u"].shape[1:3])
             for n in ("in_proj", "x_proj", "dt_proj", "out_proj")}
    per_layer = sum(t.numel() * t.element_size()
                    for t in _leaves(params["pos0"])) / cfg.n_layers
    emb = params["embed"]["e"]
    print(f"[falcon-mamba-7b] a layer's PTC block grids (P x Q blocks of "
          f"{cfg.ptc.k} x {cfg.ptc.k}): " + ", ".join(
              f"{n} {p} x {q}" for n, (p, q) in grids.items())
          + f"; {per_layer / 1e6:.1f} MB a layer, embedding "
          f"{emb.numel() * emb.element_size() / 1e9:.2f} GB")
    check(grids == {"in_proj": (128, 32), "x_proj": (3, 64),
                    "dt_proj": (64, 2), "out_proj": (32, 64)},
          f"falcon-mamba-7b: block grids {grids}")

    # the solo serve path, logits traced (one (4, vocab) copy to the host
    # a step, beside the argmax the loop copies anyway)
    batch, plen, gen = 4, 32, 32
    args = argparse.Namespace(arch=cfg, batch=batch, prompt_len=plen,
                              gen=gen, seed=0, device=dev,
                              params_override=params, trace_logits=True)
    t0 = time.perf_counter()
    serve.run(argparse.Namespace(**{**vars(args), "prompt_len": 2,
                                    "gen": 2}))
    print(f"[falcon-mamba-7b] solo warm-up (3 steps): "
          f"{time.perf_counter() - t0:.1f} s")
    out = serve.run(args)
    steps = plen + gen - 1
    check(out["gen"].shape == (batch, gen)
          and bool(((out["gen"] >= 0) & (out["gen"] < cfg.vocab)).all())
          and bool(np.isfinite(out["logits"]).all()),
          "falcon-mamba-7b: bad solo tokens or logits")
    print(f"[falcon-mamba-7b] solo serve, batch {batch}, prompt {plen}, "
          f"{gen} new tokens: {out['gen'].size} tokens in "
          f"{out['wall_s']:.2f} s of wall ({out['tokens_per_s']:.1f} "
          f"tokens/s), {steps} steps, {1e3 * out['wall_s'] / steps:.1f} ms "
          f"a step; {card_line()}")
    serve_step_profile(torch, cfg, params, batch)

    # the gateway: 8 slots, one token a step (the only chunk an ssm arch
    # takes)
    pages = PageConfig(page_size=16, n_pages=56, max_pages_per_slot=7)
    gcfg = GatewayConfig(slots=8, pages=pages, prefill_chunk=1)
    t0 = time.perf_counter()
    ServingGateway(cfg, params, gcfg, device=dev).run(poisson_workload(
        1, 1, 1.0, cfg.vocab, prompt_len=(2, 2), max_new=(2, 2)))
    torch.cuda.synchronize()
    print(f"[falcon-mamba-7b] gateway warm-up (1 short request): "
          f"{time.perf_counter() - t0:.1f} s")
    # 8 requests: with 12 the whole script took 678.4 s on an H100 whose
    # host ran slow, past half its time limit
    reqs = poisson_workload(0, 8, 0.5, cfg.vocab, prompt_len=(16, 64),
                            max_new=(8, 32))
    gw = ServingGateway(cfg, params, gcfg, device=dev)
    marks, gather = [], gw._gather_views

    def marked():                   # the host clock as each busy step starts
        marks.append(time.perf_counter())
        return gather()

    gw._gather_views = marked
    rep = gw.run(reqs)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    del gw._gather_views     # the cycle gw -> marked -> gw holds the params
    step_ms = 1e3 * np.diff(marks)
    for r in rep["requests"]:
        check(r["n_out"] == r["max_new"],
              f"falcon-mamba-7b gateway: request {r['rid']} produced "
              f"{r['n_out']} of {r['max_new']} tokens")
    print(f"[falcon-mamba-7b] gateway, {len(reqs)} requests at 0.5 per "
          f"step, prompts {min(r.prompt_len for r in reqs)}-"
          f"{max(r.prompt_len for r in reqs)}, max_new "
          f"{min(r.max_new for r in reqs)}-{max(r.max_new for r in reqs)}, "
          f"{gcfg.slots} slots, prefill chunk 1: {rep['steps']} steps "
          f"({rep['busy_steps']} busy, occupancy {rep['occupancy']:.2f}), "
          f"{rep['tokens_out']} tokens in {rep['wall_s']:.2f} s "
          f"({rep['tokens_per_s']:.1f} tokens/s); busy step median "
          f"{float(np.median(step_ms)):.1f} ms, min {step_ms.min():.1f}, "
          f"max {step_ms.max():.1f}; {card_line()}")
    del gw

    # the gateway against the solo path on the solo run's prompts, all
    # arriving at step 0: its busy step plen - 1 ends every prompt
    prompts = lm_batch(0, 0, batch, plen, cfg.vocab)["tokens"]
    gw = ServingGateway(cfg, params, GatewayConfig(
        slots=batch, pages=PageConfig(16, 6 * batch, 6), prefill_chunk=1),
        device=dev)
    step_fn, seen = gw._step_fn, []

    def step(prm, views, b):
        res = step_fn(prm, views, b)
        if len(seen) == plen - 1:
            seen.append(res[0].float().clone())
        else:
            seen.append(None)
        return res

    gw._step_fn = step
    rep = gw.run([Request(rid=i, prompt=prompts[i], max_new=gen)
                  for i in range(batch)])
    gw_logits = seen[plen - 1]
    gw_tokens = np.asarray([r["tokens"] for r in rep["requests"]])
    check(bool((gw_tokens[:, 0] == gw_logits.argmax(-1).cpu().numpy())
               .all()), "falcon-mamba-7b: the gateway's slots are not its "
                        "requests")
    solo = torch.as_tensor(out["logits"][plen - 1], device=dev)
    _, rel = rel_err(solo, gw_logits)
    same = float((out["gen"] == gw_tokens).mean())
    check(rel < SERVE_TOL, f"falcon-mamba-7b: solo vs gateway last-prompt "
                           f"logits rel err {rel:.2e} >= {SERVE_TOL}")
    print(f"[falcon-mamba-7b] gateway (4 slots) vs solo on the same "
          f"prompts: last-prompt logits within {rel:.2e} of the largest "
          f"(tol {SERVE_TOL:.0e}); {100 * same:.1f}% of the "
          f"{gw_tokens.size} generated tokens identical")
    del gw, seen, out

    # one layer: the chunked scan against 64 steps of the recurrence
    p0 = layers.tree_map(lambda a: a[0], layer)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(
        dev).manual_seed(5), device=dev).to(torch.bfloat16)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, st = ssm.mamba(p0, sc, cfg.ptc, x, return_state=True)
        torch.cuda.synchronize()
        t_scan = time.perf_counter() - t0
        state = ssm.init_ssm_state(2, sc, dev)
        ys = []
        t0 = time.perf_counter()
        for t in range(x.shape[1]):
            yt, state = ssm.mamba_decode(p0, sc, cfg.ptc, x[:, t: t + 1],
                                         state)
            ys.append(yt)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    errs = {"output": rel_err(torch.cat(ys, 1), y)[1],
            "h": rel_err(state["h"], st["h"])[1],
            "conv": rel_err(state["conv"], st["conv"])[1]}
    check(all(e < SCAN_TOL for e in errs.values()),
          f"falcon-mamba-7b: scan vs recurrence {errs} (tol {SCAN_TOL})")
    print(f"[falcon-mamba-7b] one layer, batch 2, 64 tokens: the chunked "
          f"scan ({1e3 * t_scan:.1f} ms wall, chunk {min(sc.chunk, 64)}) "
          f"against 64 steps of the recurrence ({1e3 * t_dec:.1f} ms): "
          + ", ".join(f"{k} within {v:.2e}" for k, v in errs.items())
          + f" of the largest (tol {SCAN_TOL:.0e})")
    del params, layer, p0, y, st, state, ys
    torch.cuda.empty_cache()


def qwen3_moe_phase(torch) -> None:
    """qwen3-moe-30b-a3b at full width (128 experts, top-8, bf16 bases,
    k = 128) with its depth cut to 1 of 48 layers (``MOE_LAYERS``; 48 do
    not fit one card): the solo serve path timed, and one layer's dispatch at decode
    against the dense combine of each token's top-k experts."""
    import argparse
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import ffn, layers

    dev = torch.device("cuda")
    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    params = card_params(torch, cfg, (
        f"{cfg.n_layers} of {full.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}"))
    batch, plen, gen = 4, 32, 16
    args = argparse.Namespace(arch=cfg, batch=batch, prompt_len=plen,
                              gen=gen, seed=0, device=dev,
                              params_override=params)
    t0 = time.perf_counter()
    serve.run(argparse.Namespace(**{**vars(args), "prompt_len": 2,
                                    "gen": 2}))
    print(f"[qwen3-moe-30b-a3b] solo warm-up (3 steps): "
          f"{time.perf_counter() - t0:.1f} s")
    out = serve.run(args)
    steps = plen + gen - 1
    check(out["gen"].shape == (batch, gen)
          and bool(((out["gen"] >= 0) & (out["gen"] < cfg.vocab)).all()),
          "qwen3-moe-30b-a3b: bad solo tokens")
    print(f"[qwen3-moe-30b-a3b] solo serve, batch {batch}, prompt {plen}, "
          f"{gen} new tokens: {out['gen'].size} tokens in "
          f"{out['wall_s']:.2f} s of wall ({out['tokens_per_s']:.1f} "
          f"tokens/s), {steps} steps, {1e3 * out['wall_s'] / steps:.1f} ms "
          f"a step; {card_line()}")
    serve_step_profile(torch, cfg, params, batch)

    # one layer's dispatch against the dense combine (decode: s = 1, cap
    # 1, a token's experts distinct, so nothing is dropped)
    mcfg = cfg.moe_cfg()
    p0 = layers.tree_map(lambda a: a[0], params["pos0"]["moe"])
    x = torch.randn((batch, 1, cfg.d_model), generator=torch.Generator(
        dev).manual_seed(6), device=dev).to(torch.bfloat16)
    fcfg = ffn.FFNCfg(cfg.d_model, cfg.d_ff, cfg.act)
    with torch.no_grad():
        y, aux = ffn.moe(p0, mcfg, cfg.ptc, x)
        probs = torch.softmax(x.float() @ p0["router"].T, dim=-1)
        gates, idx = ffn._top_k(probs, cfg.top_k)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        dense = torch.zeros((batch, cfg.d_model), device=dev)
        for b in range(batch):
            for j in range(cfg.top_k):
                pe = layers.tree_map(lambda a: a[int(idx[b, 0, j])],
                                     p0["experts"])
                dense[b] += gates[b, 0, j] * ffn.mlp(
                    pe, fcfg, cfg.ptc, x[b]).float()[0]
        layer_ms = cuda_ms(lambda: ffn.moe(p0, mcfg, cfg.ptc, x), reps=5)
    _, rel = rel_err(y[:, 0], dense)
    check(rel < MOE_TOL and bool(torch.isfinite(aux)),
          f"qwen3-moe-30b-a3b: dispatch vs dense combine rel err {rel:.2e} "
          f">= {MOE_TOL}")
    print(f"[qwen3-moe-30b-a3b] one MoE layer at decode (batch {batch}, "
          f"{cfg.n_experts} experts, every expert's W composed and "
          f"applied): {layer_ms:.2f} ms on the device; dispatch vs the "
          f"dense combine of each token's {cfg.top_k} experts within "
          f"{rel:.2e} of the largest (tol {MOE_TOL:.0e}), aux "
          f"{float(aux):.4f}")
    del params, p0, out
    torch.cuda.empty_cache()


def family_smoke_checks(torch) -> None:
    """Smoke width, fp32, on the card: smoke:falcon-mamba-7b through the
    gateway at chunk 1 against each request served alone; jamba, qwen3-moe
    and moonshot made on the CPU and served on the card and on the CPU."""
    import argparse
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import layers, lm
    from repro_torch.serving import (GatewayConfig, PageConfig,
                                     ServingGateway, poisson_workload)

    dev = torch.device("cuda")
    scfg = smoke_config("falcon-mamba-7b")
    sp = lm.init_model(torch.Generator(dev).manual_seed(1), scfg)
    reqs = poisson_workload(1, 8, 0.5, scfg.vocab, prompt_len=(4, 40),
                            max_new=(4, 16))
    rep = ServingGateway(scfg, sp, GatewayConfig(
        slots=4, pages=PageConfig(8, 64, 8), prefill_chunk=1),
        device=dev).run(reqs)
    for r, got in zip(reqs, rep["requests"]):
        solo = serve.run(argparse.Namespace(
            arch=scfg, batch=1, prompt_len=r.prompt_len, gen=r.max_new,
            seed=0, device=dev, params_override=sp,
            prompt_tokens=np.asarray(r.prompt)[None]))
        check([int(t) for t in solo["gen"][0]] == got["tokens"],
              f"{scfg.name}: request {r.rid} alone differs from the gateway")
    print(f"[families] {scfg.name} (fp32): each of {len(reqs)} requests "
          f"served alone emits the gateway's tokens exactly (4 slots, "
          f"prefill chunk 1, SSM states zeroed on admission)")

    for name in ("jamba-1.5-large-398b", "qwen3-moe-30b-a3b",
                 "moonshot-v1-16b-a3b"):
        cfg = smoke_config(name)
        cpu_p = lm.init_model(torch.Generator().manual_seed(2), cfg)
        card_p = layers.tree_map(lambda a: a.to(dev), cpu_p)
        # step by step from the CPU's decode state of the step before,
        # that state held in fp32: the cache's bf16 rows round activations
        # that agree to fp32 precision, and a rounding tie taken the other
        # way moves a step's logits by more than its arithmetic does
        step = lm.build_serve_step(cfg)
        prompt = torch.as_tensor(lm_batch(0, 0, 2, 8, cfg.vocab)["tokens"],
                                 dtype=torch.int64)
        cache = layers.tree_map(lambda a: a.float(), lm.init_decode_cache(
            cfg, 2, 16, device="cpu"))
        tok, worst = prompt[:, :1], 0.0
        for i in range(15):
            on_card, _ = step(card_p, layers.tree_map(lambda a: a.to(dev),
                                                      cache),
                              {"token": tok.to(dev), "cache_len": i})
            on_cpu, cache = step(cpu_p, cache, {"token": tok,
                                                "cache_len": i})
            worst = max(worst, rel_err(on_card.cpu(), on_cpu)[1])
            tok = prompt[:, i + 1: i + 2] if i + 1 < 8 else \
                on_cpu.argmax(-1, keepdim=True)
        check(worst < FAMILY_SMOKE_TOL,
              f"{cfg.name}: card vs CPU logits rel err {worst:.2e} >= "
              f"{FAMILY_SMOKE_TOL}")
        # free-running: each side feeds back its own tokens and caches;
        # its logits are compared over the steps both fed alike
        args = dict(arch=cfg, batch=2, prompt_len=8, gen=8, seed=0,
                    trace_logits=True)
        free_cpu = serve.run(argparse.Namespace(
            **args, device="cpu", params_override=cpu_p))
        free_card = serve.run(argparse.Namespace(
            **args, device=dev, params_override=card_p))
        fed = (free_cpu["preds"] != free_card["preds"]).any(0)
        fed[:7] = False                    # the prompt's steps are forced
        n = int(np.argmax(fed)) + 1 if fed.any() else fed.size
        _, free = rel_err(torch.as_tensor(free_card["logits"][:n]),
                          torch.as_tensor(free_cpu["logits"][:n]))
        same = float((free_cpu["gen"] == free_card["gen"]).mean())
        print(f"[families] {cfg.name} (fp32, CPU-made params): card vs CPU "
              f"logits within {worst:.2e} of the largest over 15 steps, each "
              f"from the CPU's state in fp32 (tol {FAMILY_SMOKE_TOL:.0e}); "
              f"run free in bf16 states, within {free:.2e} over {n} steps and "
              f"{100 * same:.1f}% of {free_cpu['gen'].size} generated "
              f"tokens identical")


def families_phase(torch) -> None:
    """The ssm, hybrid and MoE families on the serving paths.  The
    reference computes the selective scan, the recurrence and the MoE
    dispatch in plain jnp, so these paths launch none of the kernels."""
    from repro_torch.kernels import build

    before = dict(build.launch_counts)
    falcon_mamba_phase(torch)
    qwen3_moe_phase(torch)
    family_smoke_checks(torch)
    launched = {k: build.launch_counts[k] - before[k] for k in before}
    check(not any(launched.values()),
          f"families: kernels launched on paths with none: {launched}")
    print("[families] launches of the seven kernels' routes over the "
          "phase: 0 (the reference's ssm and MoE have no Pallas kernel, "
          "falcon-mamba-7b no attention; jamba's smoke attention is at "
          "decode, the dense cache)")


# ---------------------------------------------------------------------------
# phase 10: LM training (olmo-1b, whisper-base) and the vlm serve path
# ---------------------------------------------------------------------------

# one training step with the kernels against the same step with their
# plain versions, on the same masks: the loss, and the Σ-gradients (olmo-
# 1b's 7 leaves stacked over 16 layers, whisper-base's over its 6 encoder
# and 6 decoder layers) two ways: each leaf over its largest entry across
# its layers (TRAIN_SIGMA_TOL), and each layer of it over that layer's own
# largest entry (TRAIN_SIGMA_LAYER_TOL), so that a fault confined to
# layers of small gradients cannot hide under a larger layer's.  The
# plain versions round only y to bf16; the tensor-core routes also round
# U·diag(s) and W to bf16 (2^-9 of a typical entry), and those roundings
# compound backward through the layers.  On the CPU, the routes' roundings
# emulated (``kernels/ref.py``'s ``*_tc_ref``) against the plain versions
# (``tests/test_torch_train_step.py::tc_rounding_deviation``, alpha_w =
# alpha_c = 0.6) read, over the leaf's and over the layer's largest entry,
# and in the loss: olmo-1b's structure at k 128 through 16 layers 2.8e-2,
# 4.8e-2, 3.9e-6 (d_model 512, T 512, 8 CPU threads) and 2.9e-2, 4.0e-2,
# 1.5e-4 (d_model 1024, T 1024); whisper-base's at k 64 through 6 + 6
# layers (d_model 256, 2 x 128 tokens) 3.5e-2, 5.5e-2, 3.3e-5.  At d_model
# 512 the reading follows the CPU's thread count (the seeded bases' QR and
# oneDNN's bf16 sums change with it): 2.8e-2 to 4.1e-2 over the leaf's
# entry, 4.2e-2 to 4.8e-2 over the layer's, 4.1e-2 and 4.35e-2 on one
# thread, where the test pins it.  TRAIN_SIGMA_TOL is 1.46 times the
# largest, TRAIN_SIGMA_LAYER_TOL 2.5 times.  Three planted faults there (``planted_faults``)
# read, over the layer's largest entry, 2.75 (the Σ-gradient without its
# column mask), 1.16 (the feedback with its block mask ignored) and 1.08
# (the column mask dropped at the last layer only, which reads 2.8e-2 over
# the leaf's: under TRAIN_SIGMA_TOL, caught only per layer) at olmo-1b's
# d_model 512, and 1.25, 1.18 and 0.90 at whisper-base's d_model 256
TRAIN_SIGMA_TOL = 6e-2
TRAIN_SIGMA_LAYER_TOL = 1.2e-1
TRAIN_LOSS_TOL = 3e-4
# the same step with fp32 bases at 2 of 16 layers, on the 3xTF32 routes
TRAIN_FP32_TOL = 1e-4
# vlm: the teacher-forced decode's logits against forward's (the
# reference's test_decode_matches_prefill_logits allows 2e-2)
DECODE_TOL = 2e-2
TRAIN_T = 4096          # train_4k's sequence (src/repro/configs/common.py:53)
# olmo-1b's depth in the train phase (its update steps and the remat
# policies): 4 of its 16 layers, to keep the whole script within half its
# time limit with the serving_gateway phase (the train phase took
# 80.7-93.3 s at 16 layers, 52.8 s at 8 and 37.5-40.3 s at 4, on the
# H100).
# Every layer has the same width, block grids and kernel shapes
OLMO_LAYERS = 4


def blocked(cfg, base_dtype=None):
    """``cfg`` with its PTC linears in blocked mode (bases in
    ``base_dtype``, else the config's)."""
    import dataclasses
    return dataclasses.replace(cfg, ptc=dataclasses.replace(
        cfg.ptc, mode="blocked",
        base_dtype=base_dtype or cfg.ptc.base_dtype))


def ptc_routes(build) -> dict:
    return {k: build.launch_counts[k] for k in
            WIDE_KERNELS + TC_KERNELS + TF32X3_KERNELS + NARROW_PTC}


def check_routes(counts: dict, want: dict, what: str) -> None:
    for kernel, n in counts.items():
        check(n == want.get(kernel, 0),
              f"{what}: {kernel} launched {n} times, not "
              f"{want.get(kernel, 0)}")


def n_linears(cfg) -> int:
    """The PTC linears one training step runs: 7 a self-attention layer
    (q, k, v, o, gate, up, down), 4 more a cross-attention."""
    from repro_torch.models import lm
    plan, n_periods = lm.period_plan(cfg)
    n = n_periods * sum(7 + 4 * sub.cross for sub in plan)
    return n + 7 * cfg.n_enc_layers


def sigma_grads(grads) -> dict:
    """The Σ leaves of a parameter or gradient tree, by their paths."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k == "s":
                out[".".join(path)] = v
    walk(grads, ())
    return out


def sigma_errs(got: dict, want: dict) -> tuple[dict, dict]:
    """Σ-gradient differences (``sigma_grads`` trees): by leaf, over the
    leaf's largest entry; by (leaf, layer), over that layer's own."""
    whole = {n: rel_err(got[n], want[n])[1] for n in want}
    layer = {(n, i): rel_err(got[n][i], want[n][i])[1]
             for n in want for i in range(want[n].shape[0])}
    return whole, layer


def check_against_plain(torch, what: str, step, n_leaves: int) -> str:
    """One training step ``step()`` -> (loss, ``sigma_grads``) with the
    kernels against the same step with their plain versions, held to
    ``TRAIN_LOSS_TOL``, ``TRAIN_SIGMA_TOL`` and ``TRAIN_SIGMA_LAYER_TOL``;
    returns the readings as text."""
    loss_k, got = step()
    with plain_kernels(torch, what):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_p, want = step()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    whole, layer = sigma_errs(got, want)
    worst = max(layer, key=layer.get)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(len(whole) == n_leaves
          and all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{what}: {len(whole)} Σ-gradient leaves, not {n_leaves}, or "
          f"not finite")
    check(all(e < TRAIN_SIGMA_TOL for e in whole.values()),
          f"{what}: Σ-gradients against the plain versions {whole} (tol "
          f"{TRAIN_SIGMA_TOL})")
    check(layer[worst] < TRAIN_SIGMA_LAYER_TOL,
          f"{what}: Σ-gradient {worst[0]} at layer {worst[1]} within "
          f"{layer[worst]:.2e} of the layer's largest entry (tol "
          f"{TRAIN_SIGMA_LAYER_TOL})")
    check(loss_err < TRAIN_LOSS_TOL, f"{what}: loss {loss_k} against "
                                     f"the plain versions' {loss_p}")
    return (f"(same masks; the plain step {plain_s:.1f} s): loss "
            f"{loss_k:.6f} vs {loss_p:.6f} ({loss_err:.1e}, tol "
            f"{TRAIN_LOSS_TOL:.0e}); Σ-gradients within "
            f"{min(whole.values()):.1e} to {max(whole.values()):.1e} of each "
            f"leaf's largest entry (tol {TRAIN_SIGMA_TOL:.0e}), within "
            f"{layer[worst]:.1e} "
            f"of each layer's at the most ({worst[0]}, layer {worst[1]}; "
            f"tol {TRAIN_SIGMA_LAYER_TOL:.1e})")


def lm_train_batch(torch, cfg, batch: int, seq: int, dev, seed: int = 0):
    """``lm_batch`` tokens and labels on the card; encdec's frames (B, S,
    d) and vlm's image tokens (B, n_img, d) in bf16, seeded normals of
    scale 0.5, as ``input_specs`` shapes them."""
    from repro_torch.data.synthetic import lm_batch
    b = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
         for k, v in lm_batch(seed, 0, batch, seq, cfg.vocab).items()}
    g = torch.Generator(dev).manual_seed(seed + 1)
    if cfg.family == "encdec":
        b["frames"] = (0.5 * torch.randn((batch, seq, cfg.d_model),
                                         generator=g, device=dev)).to(
            torch.bfloat16)
    if cfg.family == "vlm":
        b["img"] = (0.5 * torch.randn((batch, cfg.n_img_tokens, cfg.d_model),
                                      generator=g, device=dev)).to(
            torch.bfloat16)
    return b


def olmo_train(torch) -> dict:
    """olmo-1b at full width in blocked mode, ``OLMO_LAYERS`` of its 16
    layers (k = 128, bf16 bases): four AdamW update steps through ``launch/steps.py::
    build_update_step`` on one train_4k sequence with alpha_w = alpha_c =
    0.6; each step's launches on the three tensor-core routes; a warm
    step profiled; one training step against its plain versions
    (``TRAIN_SIGMA_TOL``, ``TRAIN_LOSS_TOL``); then 2 of 16 layers with
    fp32 bases on the 3xTF32 routes against their plain versions
    (``TRAIN_FP32_TOL``).  Returns the tensor-core routes' launches in one
    update step."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import build
    from repro_torch.launch.steps import build_update_step, init_train_state
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import AdamWConfig

    dev = torch.device("cuda")
    full = blocked(get_config("olmo-1b"))
    check((full.n_layers, full.d_model, full.d_ff, full.vocab, full.ptc.k,
           full.attn_chunk, full.remat) == (16, 2048, 8192, 50304, 128, 2048,
                                            True),
          f"train: olmo-1b is {full}")
    cfg = dataclasses.replace(full, n_layers=OLMO_LAYERS)
    scfg = SparsityConfig(alpha_w=0.6, alpha_c=0.6)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt = init_train_state(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    blocks = sum(s.numel() // s.shape[-1]
                 for s in sigma_grads(params).values())
    n_lin = n_linears(cfg)
    batch = lm_train_batch(torch, cfg, 1, TRAIN_T, dev)
    print(f"[train] olmo-1b, {cfg.n_layers} of {full.n_layers} layers, "
          f"d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, PTC k = {cfg.ptc.k} blocked, "
          f"bases {cfg.ptc.base_dtype}: {blocks} blocks, parameters and "
          f"AdamW state made on the card in {init_s:.1f} s, parameters "
          f"{n_bytes / 1e9:.2f} GB; batch 1 x {TRAIN_T} (train_4k's length; "
          f"cut: batch 256 -> 1), alpha_w 0.6, alpha_c 0.6, remat full, "
          f"attention chunk {cfg.attn_chunk}")

    update = build_update_step(cfg, AdamWConfig(lr=2e-3), scfg)
    state = {"params": params, "opt": opt}
    del params, opt
    launches = {}

    def one_step(step: int):
        gen = torch.Generator(dev).manual_seed(1000 + step)
        state["params"], state["opt"], loss, gnorm = update(
            state["params"], state["opt"], batch, gen)
        return loss, gnorm

    # under remat the forward runs twice a step, the backward once
    want = dict(zip(STAGE_KERNELS["train"], (2 * n_lin, n_lin, n_lin)))
    losses, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    for step in range(4):
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, gnorm = one_step(step)
        loss = float(loss)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        counts = ptc_routes(build)
        check_routes(counts, want, f"train olmo-1b step {step}")
        launches = {k: counts[k] for k in TC_KERNELS}
        check(bool(torch.isfinite(torch.tensor(loss)))
              and bool(torch.isfinite(gnorm)),
              f"train olmo-1b step {step}: loss {loss}, gnorm {gnorm}")
        losses.append(loss)
        print(f"[train] olmo-1b update step {step}: loss {loss:.4f}, gnorm "
              f"{float(gnorm):.3f}, wall {walls[-1]:.1f} ms"
              + (" (first call)" if step == 0 else "") + "; launches "
              + ", ".join(f"{k}={counts[k]}" for k in TC_KERNELS)
              + ", every other PTC route 0")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(losses[-1] < losses[0], f"train olmo-1b: the loss did not fall "
                                  f"over four steps: {losses}")
    warm = warm_profile(torch, "olmo-1b update", lambda: one_step(4), (
        ("ptc_block_matmul_wide_tc", r"tc_(compose|product)_kernel"),
        ("sigma_grad_wide_tc", r"tc_(col_split|sigma)_kernel"),
        ("feedback_matmul_wide_tc", r"tc_(fcompose|feedback)_kernel"),
        ("gemm (attention, head)", r"gemm|nvjet|cutlass|sm90_xmma")),
        tag="train")
    print(f"[train] olmo-1b: losses {', '.join(f'{x:.4f}' for x in losses)} "
          f"(falls); warm steps {', '.join(f'{w:.1f}' for w in walls[1:])} "
          f"ms, profiled {warm:.1f} ms: {TRAIN_T / (min(walls[1:]) / 1e3):.0f}"
          f" tokens/s at the fastest; peak allocated {peak:.2f} GB; "
          f"{card_line()}")

    # one training step against the same step with the plain versions, on
    # the same masks (one generator seed)
    train = lm.build_train_step(cfg, scfg)

    def grads_of():
        loss, grads = train(state["params"], batch,
                            torch.Generator(dev).manual_seed(7))
        return float(loss), sigma_grads(grads)

    readings = check_against_plain(torch, "train olmo-1b", grads_of, 7)
    print(f"[train] olmo-1b training step, kernels vs plain versions "
          f"{readings}; {card_line()}")
    del update, train
    torch.cuda.empty_cache()
    olmo_remat(torch, cfg, state["params"], batch, scfg, n_lin)
    del state
    torch.cuda.empty_cache()

    # 2 of 16 layers with fp32 bases: the 3xTF32 routes
    cfg32 = dataclasses.replace(blocked(get_config("olmo-1b"), torch.float32),
                                n_layers=2)
    p32 = lm.init_model(torch.Generator(dev).manual_seed(0), cfg32)
    train32 = lm.build_train_step(cfg32, scfg)

    def grads32():
        loss, grads = train32(p32, batch, torch.Generator(dev).manual_seed(7))
        return float(loss), sigma_grads(grads)

    build.reset_launch_counts()
    loss_k, got = grads32()
    torch.cuda.synchronize()
    n32 = n_linears(cfg32)
    counts = ptc_routes(build)
    check_routes(counts, {"ptc_block_matmul_wide_3xtf32": 2 * n32,
                          "sigma_grad_wide_3xtf32": n32,
                          "feedback_matmul_wide_3xtf32": n32},
                 "train olmo-1b fp32")
    with plain_kernels(torch, "train olmo-1b fp32"):
        loss_p, want_g = grads32()
    errs = {n: rel_err(got[n], want_g[n])[1] for n in got}
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    check(all(e < TRAIN_FP32_TOL for e in errs.values())
          and loss_err < TRAIN_FP32_TOL,
          f"train olmo-1b fp32: loss {loss_err:.2e}, Σ-gradients {errs} "
          f"against the plain versions (tol {TRAIN_FP32_TOL})")
    print(f"[train] olmo-1b with fp32 bases, 2 of 16 layers: launches "
          + ", ".join(f"{k}={counts[k]}" for k in TF32X3_KERNELS)
          + f"; kernels vs plain versions: loss {loss_err:.1e}, Σ-gradients "
          + ", ".join(f"{n.split('.')[-1]} {e:.1e}" for n, e in errs.items())
          + f" (tol {TRAIN_FP32_TOL:.0e})")
    del p32, got, want_g
    torch.cuda.empty_cache()
    return launches


def remat_steps(torch, what: str, cfg, params, batch, scfg,
                want: dict) -> dict:
    """One training step's gradients of ``cfg`` under each remat policy
    (the same parameters, batch and masks; a warm-up call, then two timed
    calls), each policy's PTC route launches held to ``want[policy]``,
    and "dots" held bit for bit to "full".  Returns {policy: (loss,
    ``sigma_grads``, the faster call's wall ms, peak GB above the memory
    allocated before the step)}."""
    import dataclasses
    from repro_torch.kernels import build
    from repro_torch.models import lm

    dev = torch.device("cuda")

    def grads(policy):
        train = lm.build_train_step(
            dataclasses.replace(cfg, remat_policy=policy), scfg)
        loss, g = train(params, batch, torch.Generator(dev).manual_seed(7))
        return float(loss), sigma_grads(g)

    def parted(a, b) -> list:
        return ([] if a[0] == b[0] else ["loss"]) + [
            n for n in b[1] if not torch.equal(a[1][n], b[1][n])]

    out = {}
    for policy in lm.REMAT_POLICIES:
        # the warm-up leaves the step's blocks in the caching allocator
        torch.cuda.empty_cache()
        grads(policy)
        torch.cuda.synchronize()
        walls = []
        for _ in range(2):
            build.reset_launch_counts()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, g = grads(policy)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        wall = min(walls)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        counts = ptc_routes(build)
        check_routes(counts, want[policy], f"{what} remat {policy}")
        check(loss == loss and all(bool(torch.isfinite(v).all())
                                   for v in g.values()),
              f"{what} remat {policy}: loss {loss} or a Σ-gradient not "
              f"finite")
        out[policy] = (loss, g, wall, peak)
        print(f"[train] {what} remat {policy}: loss {loss:.6f}, warm step "
              f"(gradients) {walls[0]:.1f}, {walls[1]:.1f} ms, peak "
              f"{peak:.2f} GB above the "
              f"step's start; launches "
              + (", ".join(f"{k}={v}" for k, v in counts.items() if v)
                 or "no PTC kernel"))
    # "dots" keeps the products' outputs and recomputes the rest: the same
    # bits as "full", which recomputes everything
    for policy in ("dots", "none"):
        off = parted(out[policy], out["full"])
        print(f"[train] {what} remat {policy} against full: "
              + (f"loss and all {len(out['full'][1])} Σ-gradient leaves "
                 f"bit-identical" if not off else f"parts at {off}"))
        if policy == "dots" and off:
            # a route that is not deterministic parts "full" from itself
            again = parted(grads("full"), out["full"])
            fail(f"{what}: remat dots parts from full at {off}; full "
                 f"against a second full run: "
                 + (f"parts at {again}" if again else "bit-identical"))
    return out


def olmo_remat(torch, cfg, params, batch, scfg, n_lin: int) -> None:
    """olmo-1b at full width, ``OLMO_LAYERS`` of its layers, the seeded and
    trained parameters of the train phase: one training step's gradients under "full",
    "dots" and "none" in blocked mode (the tensor-core routes) and in
    olmo-1b's own fused mode (no PTC kernel), with the fused peaks
    ordered full < dots < none."""
    import dataclasses
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    tc = dict(zip(STAGE_KERNELS["train"], (2 * n_lin, n_lin, n_lin)))
    remat_steps(torch, "olmo-1b blocked", cfg, params, batch, scfg, {
        "full": tc, "dots": tc,
        "none": dict(zip(STAGE_KERNELS["train"], (n_lin, n_lin, n_lin)))})
    fused = dataclasses.replace(get_config("olmo-1b"), n_layers=cfg.n_layers)
    check(fused.ptc.mode == "fused" and fused.ptc.base_dtype
          == cfg.ptc.base_dtype and fused.remat,
          f"train: olmo-1b's own config is {fused.ptc}")
    out = remat_steps(torch, "olmo-1b fused", fused, params, batch, scfg,
                      dict.fromkeys(("full", "dots", "none"), {}))
    peaks = {p: out[p][3] for p in out}
    check(peaks["full"] < peaks["dots"] < peaks["none"],
          f"train olmo-1b fused: peaks {peaks} GB not ordered full < dots "
          f"< none")
    print(f"[train] olmo-1b fused, warm step walls: "
          + ", ".join(f"{p} {out[p][2]:.1f} ms" for p in out)
          + "; peaks above the step's start: "
          + ", ".join(f"{p} {peaks[p]:.2f} GB" for p in out)
          + f" (full < dots < none); the remat policies "
          f"{time.perf_counter() - t0:.1f} s; {card_line()}")


def whisper_train(torch) -> None:
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, d_model 512, k = 64, bf16 bases) in blocked mode: two update
    steps on batch 8 x 512 with seeded frames, on the k = 64 tensor-core
    routes; one training step against its plain versions; then its solo
    serve path with ``enc_out``."""
    import argparse
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_update_step, init_train_state
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import AdamWConfig

    dev = torch.device("cuda")
    cfg = blocked(get_config("whisper-base"))
    check((cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.ptc.k)
          == (6, 6, 512, 64), f"train: whisper-base is {cfg}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt = init_train_state(torch.Generator(dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    grids = sorted({tuple(t.shape[1:3])
                    for t in sigma_grads(params).values()})
    b, seq = 8, 512
    batch = lm_train_batch(torch, cfg, b, seq, dev)
    scfg = SparsityConfig(alpha_w=0.6, alpha_c=0.6)
    update = build_update_step(cfg, AdamWConfig(lr=2e-3), scfg)
    n_lin = n_linears(cfg)
    want = dict(zip(STAGE_KERNELS["train"], (2 * n_lin, n_lin, n_lin)))
    losses, walls = [], []
    for step in range(2):
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss, _ = update(params, opt, batch, torch.Generator(
            dev).manual_seed(step))
        losses.append(float(loss))
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        counts = ptc_routes(build)
        check_routes(counts, want, f"train whisper-base step {step}")
    check(all(np.isfinite(losses)), f"train whisper-base: losses {losses}")
    print(f"[train] whisper-base, {cfg.n_enc_layers} + {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, k = {cfg.ptc.k} blocked, bf16 "
          f"bases, block grids (P, Q) {grids}, made in {init_s:.1f} s; "
          f"batch {b} x {seq} with frames (B, S, d), alpha_w = alpha_c = "
          f"0.6: losses {', '.join(f'{x:.4f}' for x in losses)}, walls "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms (the first a first "
          f"call); launches a step " + ", ".join(
              f"{k}={counts[k]}" for k in TC_KERNELS)
          + f" (k = 64), every other PTC route 0; {card_line()}")

    # one training step against the same step with the plain versions, on
    # the same masks, at the grids the update steps ran
    train = lm.build_train_step(cfg, scfg)

    def grads_of():
        loss, grads = train(params, batch, torch.Generator(dev).manual_seed(7))
        return float(loss), sigma_grads(grads)

    n_leaves = len(sigma_grads(params))
    readings = check_against_plain(torch, "train whisper-base", grads_of,
                                   n_leaves)
    print(f"[train] whisper-base training step, kernels vs plain versions "
          f"{readings}; {card_line()}")
    del train

    args = argparse.Namespace(arch=cfg, batch=4, prompt_len=32, gen=16,
                              seed=0, device=dev, params_override=params,
                              trace_logits=True)
    build.reset_launch_counts()
    out = serve.run(args)
    counts = ptc_routes(build)
    check(out["gen"].shape == (4, 16)
          and bool(((out["gen"] >= 0) & (out["gen"] < cfg.vocab)).all())
          and bool(np.isfinite(out["logits"]).all())
          and counts["ptc_block_matmul_wide_tc"] > 0,
          f"whisper-base serve: bad tokens, logits or launches {counts}")
    print(f"[train] whisper-base solo serve (blocked, enc_out of 32 frames, "
          f"batch 4, prompt 32, 16 new tokens): {out['gen'].size} tokens in "
          f"{out['wall_s']:.2f} s ({out['tokens_per_s']:.1f} tokens/s), "
          f"ptc_block_matmul_wide_tc launches "
          f"{counts['ptc_block_matmul_wide_tc']}")
    del params, opt, out
    torch.cuda.empty_cache()


def vlm_serve(torch) -> None:
    """llama-3.2-vision-11b at full width, depth cut to 1 of 8 periods (5
    of 40 layers, 1 of them with cross-attention; ``VLM_PERIODS``), fused
    PTC with bf16
    bases: the solo serve path through ``launch.serve.run`` (batch 4,
    prompt 32, 16 new tokens, 1,024 image tokens), its teacher-forced
    logits against ``forward``'s on the same prompts and image tokens."""
    import argparse
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve
    from repro_torch.models import lm

    dev = torch.device("cuda")
    full = get_config("llama-3.2-vision-11b")
    cfg = dataclasses.replace(full,
                              n_layers=VLM_PERIODS * full.cross_attn_period)
    params = card_params(torch, cfg, (
        f"{cfg.n_layers} of {full.n_layers} layers ({cfg.n_layers // cfg.
        cross_attn_period} with cross-attention), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, d_ff "
        f"{cfg.d_ff}, {cfg.n_img_tokens} image tokens"))
    batch, plen, gen = 4, 32, 16
    args = argparse.Namespace(arch=cfg, batch=batch, prompt_len=plen,
                              gen=gen, seed=0, device=dev,
                              params_override=params, trace_logits=True)
    serve.run(argparse.Namespace(**{**vars(args), "prompt_len": 2,
                                    "gen": 2}))
    out = serve.run(args)
    steps = plen + gen - 1
    check(out["gen"].shape == (batch, gen)
          and bool(((out["gen"] >= 0) & (out["gen"] < cfg.vocab)).all())
          and bool(np.isfinite(out["logits"]).all()),
          "llama-3.2-vision-11b: bad solo tokens or logits")
    prompt = torch.as_tensor(lm_batch(0, 0, batch, plen, cfg.vocab)[
        "tokens"], dtype=torch.int64, device=dev)
    img = 0.1 * torch.ones((batch, cfg.n_img_tokens, cfg.d_model),
                           device=dev)
    with torch.no_grad():
        logits, _ = lm.forward(params, cfg, {"tokens": prompt, "img": img})
    decoded = torch.as_tensor(out["logits"][:plen], device=dev)
    _, rel = rel_err(decoded, logits.float().transpose(0, 1))
    check(rel < DECODE_TOL, f"llama-3.2-vision-11b: teacher-forced decode "
                            f"vs forward logits rel err {rel:.2e}")
    print(f"[train] llama-3.2-vision-11b solo serve, batch {batch}, prompt "
          f"{plen}, {gen} new tokens, {cfg.n_img_tokens} image tokens of "
          f"0.1: {out['gen'].size} tokens in {out['wall_s']:.2f} s "
          f"({out['tokens_per_s']:.1f} tokens/s), {steps} steps, "
          f"{1e3 * out['wall_s'] / steps:.1f} ms a step; teacher-forced "
          f"logits within {rel:.2e} of forward's largest (tol "
          f"{DECODE_TOL:.0e}); {card_line()}")
    del params, out, logits
    torch.cuda.empty_cache()


def train_driver(torch) -> None:
    """``repro_torch.launch.train`` at smoke:olmo-1b on the card: 12
    steps with a checkpoint every 5, then a restart to 16 steps that
    resumes from step 10."""
    import shutil
    from repro_torch.launch import train

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", "smoke:olmo-1b", "--batch", "4", "--seq", "32",
            "--lr", "5e-3", "--ckpt-dir", str(ckpt), "--ckpt-every", "5",
            "--log-every", "100"]
    ap = train.arg_parser()
    first = train.train(ap.parse_args(argv + ["--steps", "12"]))
    again = train.train(ap.parse_args(argv + ["--steps", "16"]))
    shutil.rmtree(ckpt, ignore_errors=True)
    check(first["steps_run"] == 12 and first["losses"][-1]
          < first["losses"][0], f"train driver: {first}")
    check(again["resumed_from"] == 10 and again["steps_run"] == 5,
          f"train driver resume: {again}")
    print(f"[train] launch.train at smoke:olmo-1b on the card: 12 steps, "
          f"loss {first['losses'][0]:.4f} -> {first['losses'][-1]:.4f} in "
          f"{first['wall_s']:.2f} s; restarted to 16 steps, resumed from "
          f"step {again['resumed_from']} and ran {again['steps_run']}")


def train_phase(torch) -> dict:
    """LM training on the card: olmo-1b's blocked update step at full
    width, ``OLMO_LAYERS`` of its 16 layers (k = 128), whisper-base's (k = 64) and its serve path,
    llama-3.2-vision-11b's serve path against its forward, and the
    training driver.  Returns the tensor-core routes' launches over one
    olmo-1b update step."""
    t0 = time.perf_counter()
    launches = olmo_train(torch)
    whisper_train(torch)
    vlm_serve(torch)
    train_driver(torch)
    print(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 11b: the examples
# ---------------------------------------------------------------------------

# the onchip_transfer example against its plain versions on the same
# draws, fp32 at k = 9: Σ after each run's first 10 steps over its largest
# entry (the kernels and the plain versions sum in other orders), and each
# run's final held-out accuracy (768 rows)
TRANSFER_SIGMA_TOL = 1e-5
TRANSFER_ACC_TOL = 0.01
# train_lm at the 100m preset: the reference's docstring runs 300 steps;
# 100 when a 20-step probe's median step says 300 would take longer than
# this
TRAIN_LM_BUDGET_S = 20.0


def _prefixed(tag: str):
    def log(msg: str) -> None:
        for line in msg.strip("\n").splitlines():
            print(f"[{tag}] {line}")
    return log


def examples_phase(torch) -> None:
    """``repro_torch.onchip_transfer.run`` on the card, each stage's
    launches, and against the same run with the plain versions; then
    ``repro_torch.train_lm.run`` at the 100m preset."""
    import numpy as np
    from repro_torch import onchip_transfer, train_lm
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    info = build.build(sorted({build.KERNELS[k] for k in QUICKSTART_KERNELS}))
    if info["built"]:
        print(f"[examples] built {info['built']} in {info['seconds']:.1f} s")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = onchip_transfer.run("cuda", log=_prefixed("examples"))
    wall = time.perf_counter() - t0
    stages = res["stages"]
    for name, st in stages.items():
        print(f"[examples] onchip_transfer stage {name}: {st['seconds']:.2f} "
              f"s, launches " + (", ".join(
                  f"{k}={v}" for k, v in sorted(st["launches"].items()))
                  or "none"))
    named = {"pm": STAGE_KERNELS["transfer_pm"],
             **dict.fromkeys(onchip_transfer.CURVES,
                             STAGE_KERNELS["transfer_sigma"])}
    for name, kernels in named.items():
        got = stages[name]["launches"]
        for kernel in kernels:
            check(got.get(kernel, 0) > 0,
                  f"examples: onchip_transfer {name} launched no {kernel}")
        for kernel in PTC_ROUTES:
            check(kernel in kernels or not got.get(kernel),
                  f"examples: onchip_transfer {name} launched {kernel}, "
                  f"not the route its entry names")
    check(not stages["pretrain"]["launches"],
          f"examples: the dense pre-training launched "
          f"{stages['pretrain']['launches']}")

    with plain_kernels(torch, "examples onchip_transfer"):
        t0 = time.perf_counter()
        plain = onchip_transfer.run("cuda", log=lambda m: None)
        plain_s = time.perf_counter() - t0
    curves = onchip_transfer.CURVES
    sig = {c: max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(res["sigma10"][c], plain["sigma10"][c]))
           for c in curves}
    acc = {c: abs(res["curves"][c][-1][1] - plain["curves"][c][-1][1])
           for c in curves}
    check(all(e <= TRANSFER_SIGMA_TOL for e in sig.values()),
          f"examples: onchip_transfer Σ after 10 steps against the plain "
          f"versions {sig} (tol {TRANSFER_SIGMA_TOL})")
    check(all(e <= TRANSFER_ACC_TOL for e in acc.values()),
          f"examples: onchip_transfer final accuracies against the plain "
          f"versions {acc} (tol {TRANSFER_ACC_TOL})")
    print(f"[examples] onchip_transfer on the card: task A mapped accuracy "
          f"{res['mapped_acc']:.4f}; final accuracies "
          + ", ".join(f"{c} {res['curves'][c][-1][1]:.4f}" for c in curves)
          + f"; wall {wall:.1f} s; against the plain versions on the same "
          f"draws ({plain_s:.1f} s): Σ after 10 steps within "
          + ", ".join(f"{c} {sig[c]:.1e}" for c in curves)
          + f" of the largest entry (tol {TRANSFER_SIGMA_TOL:.0e}), final "
          f"accuracies within "
          + ", ".join(f"{c} {acc[c]:.4f}" for c in curves)
          + f" (tol {TRANSFER_ACC_TOL}), mapped {plain['mapped_acc']:.4f}; "
          f"{card_line()}")

    quiet = dict(device="cuda", log_every=10 ** 9)
    probe = train_lm.run("100m", steps=20, **quiet)
    step_s = float(np.median(probe["step_s"]))
    steps = 300 if 300 * step_s <= TRAIN_LM_BUDGET_S else 100
    print(f"[examples] train_lm 100m probe: 20 steps in "
          f"{probe['wall_s']:.2f} s, median step {1e3 * step_s:.1f} ms, so "
          f"{steps} steps (300 if they fit in {TRAIN_LM_BUDGET_S:.0f} s, "
          f"else 100)")
    build.reset_launch_counts()
    got = train_lm.run("100m", steps=steps, **quiet)
    launched = {k: v for k, v in build.launch_counts.items() if v}
    first, last = np.mean(got["losses"][:10]), np.mean(got["losses"][-10:])
    vocab = train_lm.PRESETS["100m"]["vocab"]
    check(last < first, f"examples: train_lm's last-10 mean loss {last} "
                        f"not below its first-10 {first}")
    check(not launched, f"examples: train_lm (fused, no remat) launched "
                        f"{launched}")
    print(f"[examples] train_lm 100m on the card: {got['n_params'] / 1e6:.1f}"
          f"M stored parameters, {steps} steps in {got['wall_s']:.1f} s "
          f"({1e3 * got['wall_s'] / steps:.1f} ms a step); first-10 mean "
          f"loss {first:.4f}, last-10 {last:.4f} (ln vocab "
          f"{np.log(vocab):.2f}, task floor ln 4 = {np.log(4):.2f}); no "
          f"kernel launched; {card_line()}")
    print(f"[examples] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 12: hardware-in-the-loop LM serving
# ---------------------------------------------------------------------------

# the fleet's block size for hw-logits serving, the reference's own choice
# (benchmarks/e2e_accuracy.py:53, benchmarks/fleet_autopilot.py:258)
HW_FLEET_K = 8
HW_CHIPS = 2
HW_BATCH, HW_PROMPT, HW_GEN = 4, 16, 16
# leg B: one of whisper-base's six decoder layers under drift, the closed
# loop on, for this many decode steps (a tick each)
HW_DRIFT_LAYERS = 1
HW_DRIFT_STEPS = 64
# leg A's first steps recomputed with the plain versions
HW_PLAIN_STEPS = 4
# routed against shadow and kernels against plain versions: max |logit
# difference| over the largest |logit| at each step.  Both sides compute
# every PTC product in fp32 from one realized transfer, in another
# summation order (about 1e-6 of a product's largest entry a layer); the
# dense KV cache holds K/V in bf16, so a new row whose fp32 value sits at a
# bf16 rounding tie may round either way, which moved a step's logits by up
# to 3e-4 of the largest between two devices serving one fp32 state (the
# families phase's moonshot check).  On an H100 routed against shadow read
# 1.17e-4 and the plain versions 2.03e-4; argmaxes must agree wherever the
# routed top-2 gap exceeds the limit
HW_TOL = 1e-3
HW_KERNELS = ("mesh_apply", "ptc_block_matmul", "ptc_block_matmul_perblock")
HW_STAGES = ("hw_deploy", "hw_step", "hw_tick")
# the reference's fleet_autopilot at --budget quick on a CPU, as its
# committed bench_artifacts/BENCH_fleet_autopilot.json records it
REFERENCE_AUTOPILOT = dict(
    alarms=(40, 20), recals=(40, 60), mean_err=(0.03120, 0.02588),
    slo=(0.9702, 0.9085), gateway_tokens=(81, 81), load_samples=44,
    sensitivity_rank_ok=True)


def _hw_counts() -> dict:
    from repro_torch.kernels import build
    return {k: build.launch_counts[k] for k in HW_KERNELS}


def _add_counts(into: dict, c0: dict) -> None:
    for k, v in _hw_counts().items():
        into[k] += v - c0[k]


def _instrument_plane(torch, plane) -> dict:
    """Time and count a plane's steps, its router's ticks and repairs, and
    record the chip each pass was routed to (instance attributes wrap the
    plane's and the router's own methods)."""
    st = dict(step_walls=[], tick_walls=[], recal_walls=[], chips=[],
              step=dict.fromkeys(HW_KERNELS, 0),
              tick=dict.fromkeys(HW_KERNELS, 0))
    router = plane.router
    tick, route_pass, finish = router.tick, router.route_pass, \
        router._finish_recal
    step = plane.step

    def timed_tick(dt=1.0):
        c0 = _hw_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick(dt)
        torch.cuda.synchronize()
        st["tick_walls"].append(time.perf_counter() - t0)
        _add_counts(st["tick"], c0)

    def routed():
        chip = route_pass()
        st["chips"].append(None if chip is None else chip.chip_id)
        return chip

    def timed_finish(chip):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finish(chip)
        torch.cuda.synchronize()
        st["recal_walls"].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def timed_step(i, valid=None):
        c0 = _hw_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with step(i, valid):
            yield
        torch.cuda.synchronize()
        st["step_walls"].append(time.perf_counter() - t0)
        _add_counts(st["step"], c0)

    router.tick, router.route_pass = timed_tick, routed
    router._finish_recal, plane.step = timed_finish, timed_step
    return st


def _wire(chips) -> tuple[int, int]:
    """(frames, bytes both ways) the chips' stream drivers have sent and
    received so far; (0, 0) on the twin transport."""
    frames = sum(getattr(c.driver, "rpc_count", 0) for c in chips)
    nbytes = sum(sum(getattr(c.driver, "wire_bytes", (0, 0))) for c in chips)
    return frames, nbytes


@contextlib.contextmanager
def hw_instrument(torch, snapshot: bool = False):
    """Every ``HwServePlane`` built in the block (by ``launch.serve``, the
    gateway or the seam) is kept with its deploy wall, the batched
    decomposition's share of it, its deploy launches, its step/tick stats
    and (``snapshot``) the fleet's state right after deploying it."""
    from repro_torch.core import unitary
    from repro_torch.runtime import hw_serve

    rec = dict(planes=[], deploy_s=[], decompose_s=[], deploy=[], stats=[],
               snap=[], wire0=[])
    orig_init, orig_dec = hw_serve.HwServePlane.__init__, \
        unitary.decompose_batched
    dec = [0.0]

    def decompose(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_dec(*a, **kw)
        torch.cuda.synchronize()
        dec[0] += time.perf_counter() - t0
        return out

    def init(self, *a, **kw):
        c0, dec[0] = _hw_counts(), 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig_init(self, *a, **kw)
        torch.cuda.synchronize()
        rec["deploy_s"].append(time.perf_counter() - t0)
        rec["decompose_s"].append(dec[0])
        rec["deploy"].append(dict.fromkeys(HW_KERNELS, 0))
        _add_counts(rec["deploy"][-1], c0)
        rec["snap"].append(_fleet_snapshot(self.router.chips)
                           if snapshot else None)
        rec["wire0"].append(_wire(self.router.chips))
        rec["stats"].append(_instrument_plane(torch, self))
        rec["planes"].append(self)

    hw_serve.HwServePlane.__init__ = init
    unitary.decompose_batched = decompose
    try:
        yield rec
    finally:
        hw_serve.HwServePlane.__init__ = orig_init
        unitary.decompose_batched = orig_dec


class PerStepShadow:
    """A layer-execution plane that serves step ``i`` from the shadow plane
    of the chip the routed run sent step ``i`` to."""

    def __init__(self, planes: dict, chip_of_step: list):
        self.planes, self.chip_of_step = planes, chip_of_step
        self.cur = None

    def hook(self, *a):
        return self.planes[self.cur].hook(*a)

    @contextlib.contextmanager
    def step(self, i, valid=None):
        self.cur = self.chip_of_step[i]
        with self.planes[self.cur].step(i, valid):
            yield


def logit_agreement(got: list, want, what: str) -> tuple[float, int]:
    """Per step max |got − want| over the largest |want| within HW_TOL,
    and the argmax equal wherever want's top-2 gap exceeds HW_TOL of its
    largest; returns (worst error, rows that were near-ties)."""
    import numpy as np
    worst, ties = 0.0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        scale = np.abs(w).max()
        err = float(np.abs(g - w).max() / scale)
        worst = max(worst, err)
        check(err < HW_TOL, f"{what}: step {i} logits differ by {err:.2e} "
                            f"of the largest (tol {HW_TOL})")
        top2 = np.sort(w, axis=-1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]) > HW_TOL * scale
        ties += int((~gap).sum())
        same = g.argmax(-1) == w.argmax(-1)
        check(bool(same[gap].all()),
              f"{what}: step {i} argmax differs where the top-2 gap exceeds "
              f"the tolerance")
    return worst, ties


def _stage_check(counts: dict, name: str) -> None:
    print(f"[hw_serve] stage {name}: launches "
          + ", ".join(f"{k}={counts[k]}" for k in HW_KERNELS))
    for kernel in STAGE_KERNELS[name]:
        check(counts[kernel] > 0,
              f"hw_serve: {kernel} was not launched in {name}")
    for kernel in PTC_ROUTES:
        check(kernel in STAGE_KERNELS[name] or counts[kernel] == 0,
              f"hw_serve: {name} launched {kernel} {counts[kernel]} times, "
              f"not the route its entry names")


def _hw_args(cfg, params, **over):
    import argparse
    base = dict(arch=cfg, batch=HW_BATCH, prompt_len=HW_PROMPT, gen=HW_GEN,
                seed=0, fleet=HW_CHIPS, drift=False, drift_sigma=0.0,
                probe_every=10, fleet_k=HW_FLEET_K, fleet_dim=18,
                fleet_tenants=1, fleet_driver="twin", hw_logits=True,
                hw_shadow=False, deploy_zo=False, no_recal=False,
                trace_logits=True, device="cuda", params_override=params)
    base.update(over)
    return argparse.Namespace(**base)


def _enc_out(torch, cfg):
    """The serve driver's stub encoder output (B, prompt_len, d) of 0.1."""
    return 0.1 * torch.ones((HW_BATCH, HW_PROMPT, cfg.d_model),
                            device="cuda")


def hw_leg_a(torch, cfg, params) -> dict:
    """whisper-base at full width (``HW_LAYERS`` of 6 decoder layers)
    through ``launch.serve.run`` with ``--hw-logits`` on 2 chips (σ = 0);
    routed against shadow from the
    same deployment; its first steps against the plain versions."""
    import numpy as np
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.launch.steps import greedy_decode
    from repro_torch.models import lm
    from repro_torch.runtime.hw_serve import HwServePlane

    n_tenants = 11 * cfg.n_layers
    build.reset_launch_counts()
    with hw_instrument(torch, snapshot=True) as rec:
        t0 = time.perf_counter()
        out = serve.run(_hw_args(cfg, params))
        run_s = time.perf_counter() - t0
    counts = _hw_counts()
    plane, st = rec["planes"][0], rec["stats"][0]
    chips = plane.router.chips
    rep = out["report"]
    hw = rep["hw"]
    n_steps = HW_PROMPT + HW_GEN - 1
    blocks = chips[0].driver.n_blocks
    print(f"[hw_serve] leg A: {cfg.name} at full width ({cfg.n_layers} of "
          f"6 decoder layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}), "
          f"--hw-logits on {HW_CHIPS} chips of k = {HW_FLEET_K}: "
          f"{len(hw['layers'])} PTC layers as tenants, {blocks} blocks a "
          f"chip; batch {HW_BATCH}, prompt {HW_PROMPT}, {HW_GEN} new "
          f"tokens, sigma_drift 0")
    check(len(hw["layers"]) == n_tenants,
          f"hw_serve: {len(hw['layers'])} tenants, expected {n_tenants}")
    check(blocks == 81_920 * cfg.n_layers,
          f"hw_serve: {blocks} blocks a chip")
    deploy_s, dec_s = rec["deploy_s"][0], rec["decompose_s"][0]
    print(f"[hw_serve] deploy (make_fleet: PM of {n_tenants} tenants on each "
          f"of {HW_CHIPS} chips, and the shadow readback): {deploy_s:.2f} s, "
          f"of which the batched decomposition {dec_s:.2f} s "
          f"({dec_s / HW_CHIPS:.2f} s a chip, {2 * blocks} decompositions "
          f"a chip) and the rest {deploy_s - dec_s:.2f} s; serve.run "
          f"{run_s:.2f} s in all")
    stage = {"hw_deploy": rec["deploy"][0], "hw_tick": st["tick"],
             "hw_step": {k: st["step"][k] - st["tick"][k]
                         for k in HW_KERNELS}}
    for name in HW_STAGES:
        _stage_check(stage[name], name)
    check(sum(sum(stage[s].values()) for s in HW_STAGES)
          == sum(counts.values()), "hw_serve: launches outside the stages")
    walls = st["step_walls"]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"[hw_serve] {hw['steps']} steps: first {1e3 * walls[0]:.1f} ms, "
          f"warm median {1e3 * warm:.1f} ms (min {1e3 * min(walls):.1f}, max "
          f"{1e3 * max(walls):.1f}), ticks median "
          f"{1e3 * sorted(st['tick_walls'])[len(walls) // 2]:.1f} ms; per "
          f"step " + ", ".join(f"{k} {stage['hw_step'][k] / hw['steps']:.1f}"
                               for k in HW_KERNELS)
          + f"; {out['tokens_per_s']:.1f} tokens/s")
    print(f"[hw_serve] frames {hw['frames']} ({hw['frames_per_step']:.1f} a "
          f"step), columns a frame {hw['cols_per_frame']:.2f}, hw_calls "
          f"{hw['hw_calls']}, shadow_calls {hw['shadow_calls']}, "
          f"dropped_passes {hw['dropped_passes']}; passes per chip "
          + ", ".join(f"{c}: {st['chips'].count(c)}"
                      for c in sorted(set(st["chips"]), key=str)))
    check(hw["steps"] == n_steps, f"hw_serve: {hw['steps']} steps")
    check(hw["frames_per_step"] == 7.0 * cfg.n_layers,
          f"hw_serve: {hw['frames_per_step']} frames a step, expected "
          f"{7 * cfg.n_layers} (self qkv, wo, cross wq, cross kv, cross wo, "
          f"gateup, down a layer)")
    check(hw["dropped_passes"] == 0 and hw["shadow_calls"] == 0,
          "hw_serve: a pass went to the shadow at sigma 0")
    check(hw["hw_calls"] == n_tenants * n_steps,
          f"hw_serve: {hw['hw_calls']} hw calls")
    check(None not in st["chips"], "hw_serve: a pass found no chip")

    # routed against shadow: the routed run's tokens teacher-forced through
    # the shadow transfer of the chip each step was routed to
    dev = torch.device("cuda")
    shadows = {c: HwServePlane(None, plane.layers, plane.router.cfg, 1,
                               mode="shadow", chips=[chips[c]])
               for c in sorted(set(st["chips"]))}
    prompt = lm_batch(0, 0, HW_BATCH, HW_PROMPT, cfg.vocab)["tokens"]
    seq = np.concatenate([prompt, out["gen"][:, :-1]], axis=1)
    shadow_logits = []
    greedy_decode(lm.build_serve_step(cfg), params,
                  lm.init_decode_cache(cfg, HW_BATCH, seq.shape[1] + 1,
                                       device=dev),
                  seq, 1, extras={"enc_out": _enc_out(torch, cfg)},
                  layer_exec=PerStepShadow(shadows, st["chips"]),
                  logits_out=shadow_logits)
    for c, sp in shadows.items():
        srep = sp.report()["hw"]
        check(srep["hw_calls"] == 0 and srep["shadow_calls"] > 0,
              "hw_serve: the shadow run reached a chip")
    worst, ties = logit_agreement(out["logits"], shadow_logits,
                                  "hw_serve routed vs shadow")
    print(f"[hw_serve] routed against shadow (the same deployment, the routed "
          f"tokens teacher-forced through each step's chip's readback "
          f"transfer): {len(shadow_logits)} steps, logits within "
          f"{worst:.2e} of the largest (tol {HW_TOL}), argmax equal but for "
          f"{ties} near-tie rows (top-2 gap within the tolerance)")

    # the first steps from the same deployed state, plain versions
    _fleet_restore(chips, rec["snap"][0])
    plain_plane = HwServePlane(None, plane.layers, plane.router.cfg,
                               len(chips), mode="route", seed=0, chips=chips)
    plain_logits = []
    t0 = time.perf_counter()
    with plain_kernels(torch, "hw_serve plain"):
        greedy_decode(lm.build_serve_step(cfg), params,
                      lm.init_decode_cache(cfg, HW_BATCH, HW_PLAIN_STEPS + 1,
                                           device=dev),
                      prompt[:, :HW_PLAIN_STEPS + 1], 0,
                      extras={"enc_out": _enc_out(torch, cfg)},
                      layer_exec=plain_plane, logits_out=plain_logits)
    plain_s = time.perf_counter() - t0
    worst_p, ties_p = logit_agreement(
        plain_logits, out["logits"][:HW_PLAIN_STEPS], "hw_serve plain")
    check(plain_plane.report()["hw"]["hw_calls"] == n_tenants * HW_PLAIN_STEPS,
          "hw_serve plain: a pass left the chips")
    print(f"[hw_serve] kernels against plain versions: the first "
          f"{HW_PLAIN_STEPS} routed steps recomputed from the deployed state "
          f"with the plain versions ({plain_s:.2f} s): logits within "
          f"{worst_p:.2e} of the largest (tol {HW_TOL}), {ties_p} near-tie "
          f"rows")
    for p in list(shadows.values()) + [plain_plane]:
        p.close()
    return dict(stage=stage, launches=counts, deploy_s=deploy_s,
                decompose_s=dec_s, warm_ms=1e3 * warm, out=out)


def hw_leg_b(torch, full) -> None:
    """One of whisper-base's decoder layers at full width under drift with
    the closed loop on: alarms, repairs that clear, every pass accounted."""
    import dataclasses
    from repro_torch.launch import serve

    cfg = dataclasses.replace(full, n_layers=HW_DRIFT_LAYERS)
    params = card_params(torch, cfg, f"{HW_DRIFT_LAYERS} of 6 decoder "
                                     f"layers, d_model {cfg.d_model}")
    gen = HW_DRIFT_STEPS - HW_PROMPT + 1
    with hw_instrument(torch) as rec:
        t0 = time.perf_counter()
        out = serve.run(_hw_args(cfg, params, gen=gen, drift=True,
                                 drift_sigma=CLOSED_LOOP_SIGMA,
                                 trace_logits=False))
        run_s = time.perf_counter() - t0
    st, rep = rec["stats"][0], out["report"]
    hw = rep["hw"]
    n_ten = 11 * cfg.n_layers
    blocks = rec["planes"][0].router.chips[0].driver.n_blocks
    cfg_rt = rec["planes"][0].router.cfg
    print(f"[hw_serve] leg B: {HW_DRIFT_LAYERS} decoder layer, {n_ten} "
          f"tenants, {blocks} blocks a chip; sigma_drift {CLOSED_LOOP_SIGMA}, "
          f"probes every {cfg_rt.probe_every} ticks, alarm "
          f"{cfg_rt.monitor.alarm_threshold} x{cfg_rt.monitor.consecutive}, "
          f"clear {cfg_rt.monitor.clear_threshold}; {hw['steps']} steps in "
          f"{run_s:.2f} s (deploy {rec['deploy_s'][0]:.2f} s)")
    for ev in rep["events"]:
        if ev["event"] in ("alarm", "recal_done"):
            print(f"[hw_serve] event t={ev['tick']}: " + ", ".join(
                f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in ev.items() if k != "tick"))
    ticks = sorted(st["tick_walls"])
    recal = st["recal_walls"]
    per_tick = 56 * blocks           # 2 meshes of 28 phase biases a block
    print(f"[hw_serve] ticks median {1e3 * ticks[len(ticks) // 2]:.1f} ms "
          f"(max {1e3 * ticks[-1]:.1f}, repairs inside); {len(recal)} "
          f"repairs of {min(recal, default=0):.2f}-{max(recal, default=0):.2f}"
          f" s; drift normals a chip a tick {per_tick / 1e6:.2f} M here, "
          f"{56 * 491_520 / 1e6:.1f} M at 6 layers (491,520 x 56), against "
          f"1.9 M in the closed_loop phase")
    print(f"[hw_serve] hw_calls {hw['hw_calls']}, shadow_calls "
          f"{hw['shadow_calls']}, dropped_passes {hw['dropped_passes']}, "
          f"frames {hw['frames_per_step']:.1f} a step")
    alarms = [ev for ev in rep["events"] if ev["event"] == "alarm"]
    dones = [ev for ev in rep["events"] if ev["event"] == "recal_done"]
    check(alarms, "hw_serve leg B: no alarm fired")
    check(dones, "hw_serve leg B: no repair landed")
    thr = cfg_rt.monitor.alarm_threshold
    check(all(ev["dist_after"] < thr for ev in dones),
          f"hw_serve leg B: a repair did not clear below {thr}")
    check(hw["hw_calls"] + hw["shadow_calls"] == n_ten * hw["steps"],
          "hw_serve leg B: a pass went unaccounted")
    check(hw["steps"] == HW_DRIFT_STEPS, f"hw_serve leg B: {hw['steps']}")


def hw_leg_c(torch) -> None:
    """The port's fleet_autopilot through its runner on the card (its
    gateway leg: smoke:qwen3-4b, --hw-logits --autopilot); chunked prefill
    through the hw gateway against the one-token path."""
    import argparse
    import numpy as np
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.models import layers, lm
    from repro_torch.serving import Request
    from repro_torch.serving.gateway import run as gw_run

    recs = bench_run.run("quick", only="fleet_autopilot", device="cuda",
                         benches=bench_run.RUNTIME)
    s = recs[0]["tables"]["summary"]
    ref = REFERENCE_AUTOPILOT
    base, ap, gw = s["reactive"], s["autopilot"], s["gateway"]
    print(f"[hw_serve] fleet_autopilot (quick) {recs[0]['seconds']:.1f} s: "
          f"alarms {base['alarms']} / {ap['alarms']} (reference CPU "
          f"{ref['alarms'][0]} / {ref['alarms'][1]}), recals {base['recals']}"
          f" / {ap['recals']} ({ref['recals'][0]} / {ref['recals'][1]}), "
          f"mean err {base['mean_err']:.5f} / {ap['mean_err']:.5f} "
          f"({ref['mean_err'][0]} / {ref['mean_err'][1]}), SLO "
          f"{base['slo_attainment']:.4f} / {ap['slo_attainment']:.4f} "
          f"({ref['slo'][0]} / {ref['slo'][1]}), sensitivity rank "
          f"{s['sensitivity']['rank_ok']} ({ref['sensitivity_rank_ok']}); "
          f"gates " + ", ".join(f"{k}={v}" for k, v in s["gates"].items()))
    print(f"[hw_serve] fleet_autopilot gateway leg: {gw['tokens_out']}/"
          f"{gw['expected_tokens']} tokens (reference {ref['gateway_tokens'][0]}"
          f"/{ref['gateway_tokens'][1]}), load samples "
          f"{gw['autopilot']['load_samples']} ({ref['load_samples']}), "
          f"{gw['hw']['frames_per_step']:.1f} frames a step, hw_calls "
          f"{gw['hw']['hw_calls']}, shadow_calls {gw['hw']['shadow_calls']}, "
          f"{gw['wall_s']:.2f} s; launches over the benchmark "
          + ", ".join(f"{k}={v}" for k, v in recs[0]["launches"].items()))
    check(all(s["gates"].values()), "hw_serve: a fleet_autopilot gate failed")
    check(gw["complete"] and gw["autopilot"]["load_samples"] > 0,
          "hw_serve: the fleet_autopilot gateway leg did not complete")

    # chunked prefill through the hw gateway (tests/test_chunked_prefill.py
    # :240-277 on the card): chunk 4 emits the chunk-1 tokens in fewer frames
    arch = lm.ArchConfig(name="hwtest", family="dense", n_layers=1,
                         d_model=32, n_heads=2, n_kv_heads=1, d_ff=48,
                         vocab=64, head_dim=16, remat=False,
                         ptc=layers.PTCLinearCfg(k=8,
                                                 base_dtype=torch.float32))
    params = lm.init_model(torch.Generator("cuda").manual_seed(5), arch)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, arch.vocab, size=(int(rng.integers(6, 14)),)).astype(np.int32),
        max_new=2, arrival=i) for i in range(3)]
    reps = {}
    for chunk in (1, 4):
        reps[chunk] = gw_run(argparse.Namespace(
            arch=arch, seed=5, slots=3, requests=3, rate=1.0, page_size=4,
            pages=24, max_pages_per_slot=4, max_new=(2, 4), eos_id=None,
            prefill_chunk=chunk, fleet=2, drift=False, drift_sigma=0.0,
            probe_every=4, fleet_k=8, fleet_driver="twin", hw_logits=True,
            hw_shadow=False, deploy_zo=False, no_recal=True,
            params_override=params, device="cuda",
            requests_override=[Request(rid=r.rid, prompt=r.prompt,
                                       max_new=r.max_new, arrival=r.arrival)
                               for r in reqs]))
    toks = {c: [r["tokens"] for r in reps[c]["requests"]] for c in reps}
    hw1, hw4 = reps[1]["fleet"]["hw"], reps[4]["fleet"]["hw"]
    print(f"[hw_serve] chunked prefill, hw gateway on the card: chunk 1 "
          f"{hw1['frames']} frames ({hw1['frames_per_step']:.1f} a step, "
          f"{hw1['cols_per_frame']:.2f} columns a frame), chunk 4 "
          f"{hw4['frames']} frames ({hw4['frames_per_step']:.1f} a step, "
          f"{hw4['cols_per_frame']:.2f} columns a frame); tokens equal "
          f"{toks[4] == toks[1]}")
    check(toks[4] == toks[1], "hw_serve: chunk 4 emitted other tokens")
    check(hw4["frames"] < hw1["frames"]
          and hw4["frames_per_step"] == hw1["frames_per_step"] == 4.0,
          "hw_serve: chunked prefill frames")
    check(hw1["cols_per_frame"] <= 3.0 < hw4["cols_per_frame"] < 12.0,
          "hw_serve: wide frames not compacted")


# leg A's depth, and so the driver phase's (the same leg over the socket
# transport): 1 of whisper-base's 6 decoder layers, to keep the whole
# script within half its time limit with the serving_gateway phase (on the
# H100 the socket leg A took 21.4-26.7 s at 3 layers and 13.3 s at 1, leg
# A 6.0-7.5 s and 2.1 s; at 6 layers the socket deploy alone took 31.0 s).
# Every decoder layer has the same width and block grids
HW_LAYERS = 1


def whisper_hw(torch):
    """whisper-base at full width with fp32 bases, ``HW_LAYERS`` of its 6
    decoder layers, and its seeded parameters made on the card."""
    import dataclasses
    from repro_torch.configs import get_config

    # fp32 bases, as the reference's hw-logits configs (its hwtest arch, the
    # smoke LM of benchmarks/e2e_accuracy.py) are: the chips compute every
    # product in fp32 whatever the bases, and bf16 activations would round
    # the routed and the shadow outputs apart by up to 2^-8 at a tie (4.4e-3
    # of the largest logit in a CPU run at a reduced width), above HW_TOL
    cfg = get_config("whisper-base")
    full = dataclasses.replace(cfg, ptc=dataclasses.replace(
        cfg.ptc, base_dtype=torch.float32))
    check((full.n_layers, full.d_model, full.d_ff, full.ptc.k)
          == (6, 512, 2048, 64), f"hw_serve: whisper-base is {full}")
    cfg = dataclasses.replace(full, n_layers=HW_LAYERS)
    params = card_params(torch, cfg, (
        f"{cfg.n_layers} of {full.n_layers} decoder layers (the encoder's "
        f"output is the serve driver's stub), d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}"))
    return cfg, params


def hw_serve_phase(torch) -> tuple[dict, dict]:
    """Hardware-in-the-loop LM serving: legs A (whisper-base at full width
    and depth, sigma 0), B (one layer under drift, the closed loop on) and
    C (the fleet autopilot's gateway leg, chunked prefill).  Returns leg A's
    launches (counts set to 0 just before it), and leg A's config,
    parameters and run for the driver phase."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    info = build.build(sorted({build.KERNELS[k] for k in HW_KERNELS}))
    if info["built"]:
        print(f"[hw_serve] built {info['built']} in {info['seconds']:.1f} s")
    full, params = whisper_hw(torch)
    t0 = time.perf_counter()
    a = hw_leg_a(torch, full, params)
    print(f"[hw_serve] leg A {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hw_leg_b(torch, full)
    print(f"[hw_serve] leg B {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hw_leg_c(torch)
    print(f"[hw_serve] leg C {time.perf_counter() - t0:.1f} s")
    print(f"[hw_serve] phase {time.perf_counter() - t_phase:.1f} s")
    return a["launches"], dict(cfg=full, params=params, leg_a=a)


# the driver phase: the kernels the server children launch on leg A's path
# (each child reports its own at exit), and the closed-loop session's chip
DRIVER_TRANSPORTS = ("twin", "subprocess", "socket")
DRIVER_FLOW_K, DRIVER_FLOW_DIM = 9, 72      # 64 blocks of k = 9


def _first_parting(got, want) -> str:
    """Where two logit traces part: the first step that differs and its
    largest difference over its largest logit."""
    import numpy as np
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            return (f"step {i} first, by {np.abs(g - w).max():.3e} "
                    f"({np.abs(g - w).max() / np.abs(w).max():.3e} of the "
                    f"largest logit)")
    return "no step"


def driver_leg_a(torch, cfg, params, twin) -> dict:
    """Leg A over the socket transport: every chip a server child on this
    card; the logits, tokens and meters bit for bit against the twin
    transport's run ``twin``."""
    import numpy as np
    from repro_torch.hw import subprocess_driver
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    build.reset_launch_counts()
    subprocess_driver.server_launch_counts.clear()
    with hw_instrument(torch) as rec:
        t0 = time.perf_counter()
        out = serve.run(_hw_args(cfg, params, fleet_driver="socket"))
        run_s = time.perf_counter() - t0
    parent = _hw_counts()
    child = {k: subprocess_driver.server_launch_counts[k] for k in HW_KERNELS}
    plane, st = rec["planes"][0], rec["stats"][0]
    hw, chips = out["report"]["hw"], plane.router.chips
    n_steps = hw["steps"]
    frames0, bytes0 = rec["wire0"][0]
    frames1, bytes1 = _wire(chips)
    walls = st["step_walls"]
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"[driver] leg A over the socket transport: {len(chips)} server "
          f"children on this card, {chips[0].driver.n_blocks} blocks each; "
          f"serve.run {run_s:.2f} s, deploy {rec['deploy_s'][0]:.2f} s (twin "
          f"transport {twin['deploy_s']:.2f} s), the batched decomposition "
          f"{rec['decompose_s'][0]:.2f} s of it")
    print(f"[driver] warm step median {1e3 * warm:.1f} ms (twin transport "
          f"{twin['warm_ms']:.1f} ms), first {1e3 * walls[0]:.1f} ms, ticks "
          f"median {1e3 * sorted(st['tick_walls'])[len(walls) // 2]:.1f} ms; "
          f"{hw['frames_per_step']:.1f} layer frames a step (twin "
          f"{twin['out']['report']['hw']['frames_per_step']:.1f}), "
          f"{(frames1 - frames0) / n_steps:.1f} wire frames and "
          f"{(bytes1 - bytes0) / n_steps / 1e6:.3f} MB a step both ways; "
          f"the deploy {frames0} frames, {bytes0 / 1e6:.1f} MB")
    print(f"[driver] kernel launches in the server children: "
          + ", ".join(f"{k}={child[k]}" for k in HW_KERNELS)
          + "; in this process: "
          + ", ".join(f"{k}={parent[k]}" for k in HW_KERNELS))
    for k in HW_KERNELS:
        check(child[k] > 0, f"driver: the server children launched no {k}")
    check(sum(parent.values()) == 0,
          "driver: a kernel of the served path ran in the client")
    want = twin["out"]
    same = (np.array_equal(out["logits"], want["logits"])
            and np.array_equal(out["gen"], want["gen"]))
    calls = [c["ptc_calls"] for c in out["report"]["chips"]]
    want_calls = [c["ptc_calls"] for c in want["report"]["chips"]]
    print(f"[driver] against the twin transport: logits and tokens "
          f"{'bit-identical' if same else 'differ: ' + _first_parting(out['logits'], want['logits'])}"
          f"; PTC calls per chip {calls} (twin {want_calls})")
    check(same, "driver: the socket transport's logits part from the twin's "
                f"at {_first_parting(out['logits'], want['logits'])}")
    check(calls == want_calls, "driver: the meters differ across transports")
    check(hw["frames_per_step"] == want["report"]["hw"]["frames_per_step"],
          "driver: layer frames a step differ across transports")
    return child


def driver_flows(torch) -> None:
    """One seeded session on each transport, the chip on this card: IC,
    PM of a seeded weight, 30 drifting ticks and a recalibration against
    the weight's blocks; every result equal across the three."""
    from repro_torch.core.calibration import calibrate_identity
    from repro_torch.core.mapping import parallel_map
    from repro_torch.core.noise import DEFAULT_NOISE
    from repro_torch.core.ptc import blockize
    from repro_torch.hw import DriftConfig, make_driver
    from repro_torch.optim.zo import ZOConfig
    from repro_torch.runtime.recalibrate import RecalConfig, recalibrate

    k, dim = DRIVER_FLOW_K, DRIVER_FLOW_DIM
    b = (dim // k) ** 2
    model = DEFAULT_NOISE.post_ic()   # as tests/test_driver.py's flows
    drift = DriftConfig(sigma_phase=0.03, theta=0.01)
    g = lambda seed: torch.Generator("cpu").manual_seed(seed)  # noqa: E731
    w = (torch.randn((dim, dim), generator=g(5)) / dim ** 0.5).cuda()
    blocks = blockize(w, k).reshape(b, k, k)
    # the three drivers built at once: the server children start together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(DRIVER_TRANSPORTS)) as ex:
        drivers = dict(zip(DRIVER_TRANSPORTS, ex.map(
            lambda t: make_driver(t, g(42), b, k, model, m=dim, n=dim,
                                  drift=drift, device="cuda"),
            DRIVER_TRANSPORTS)))
    print(f"[driver] the three drivers built in {time.perf_counter() - t0:.2f}"
          f" s (two server children started together)")
    outs = {}
    for transport, d in drivers.items():
        t0 = time.perf_counter()
        try:
            ic = calibrate_identity(g(1), b, k, model, restarts=2, driver=d,
                                    cfg=ZOConfig(steps=20, inner=10,
                                                 delta0=0.5))
            pm = parallel_map(g(2), w, k, model, driver=d,
                              cfg=ZOConfig(steps=20, inner=10, delta0=0.2))
            for _ in range(30):
                d.advance(1.0)
            rc = recalibrate(g(9), d, blocks,
                             RecalConfig(zo_steps=20, delta0=0.05))
            stats = d.stats.as_dict()
        finally:
            d.close()
        outs[transport] = [ic.phi_u, ic.mse_u, ic.history, pm.err_osp,
                           pm.phi_u, rc.phi, rc.sigma, rc.dist_after,
                           rc.ptc_calls, stats]
        print(f"[driver] IC, PM, drift and recal over {transport}: "
              f"{time.perf_counter() - t0:.2f} s; IC MSE "
              f"{float(ic.mse_u.mean()):.2e}, PM error after OSP "
              f"{float(pm.err_osp.mean()):.4f}, recal {float(rc.dist_before):.4f}"
              f" → {float(rc.dist_after):.4f}, {stats['total']:.0f} PTC calls")
    for transport in DRIVER_TRANSPORTS[1:]:
        for i, (a, b_) in enumerate(zip(outs["twin"], outs[transport])):
            same = (torch.equal(a.cpu(), b_.cpu())
                    if isinstance(a, torch.Tensor) else a == b_)
            check(same, f"driver: the {transport} session's result {i} "
                        f"differs from the twin's")
    print(f"[driver] the session is equal on the three transports")


def driver_phase(torch, hw: dict | None) -> dict:
    """The driver plane on the card: leg A over the socket transport
    against the twin transport's (``hw``, from the hw_serve phase, else run
    here), ``driver_overhead`` at quick, and the IC/PM/recal session on
    the three transports.  Returns the server children's launches over leg
    A."""
    import functools
    from repro_torch.benchmarks import driver_overhead, run as bench_run
    from repro_torch.benchmarks.common import ART
    from repro_torch.hw import subprocess_driver
    from repro_torch.kernels import build
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    info = build.build(sorted({build.KERNELS[k] for k in HW_KERNELS}))
    if info["built"]:
        print(f"[driver] built {info['built']} in {info['seconds']:.1f} s")
    if hw is None:
        full, params = whisper_hw(torch)
        build.reset_launch_counts()
        with hw_instrument(torch) as rec:
            out = serve.run(_hw_args(full, params))
        walls = rec["stats"][0]["step_walls"]
        hw = dict(cfg=full, params=params, leg_a=dict(
            out=out, deploy_s=rec["deploy_s"][0],
            warm_ms=1e3 * sorted(walls[1:])[len(walls[1:]) // 2]))
        print(f"[driver] leg A on the twin transport {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    child = driver_leg_a(torch, hw["cfg"], hw["params"], hw["leg_a"])
    print(f"[driver] leg A over the socket transport "
          f"{time.perf_counter() - t0:.1f} s")
    hw.clear()
    torch.cuda.empty_cache()

    subprocess_driver.server_launch_counts.clear()
    recs = bench_run.run("quick", device="cuda", benches=(
        ("hw_driver_overhead", functools.partial(
            driver_overhead.main, repeats=DRIVER_OVERHEAD_REPEATS)),))
    s = json.loads((ART / "BENCH_driver_overhead.json").read_text())
    print(f"[driver] driver_overhead (quick, each timing the median of "
          f"{s['repeats']} repeats, not 5) {recs[0]['seconds']:.1f} s; "
          f"bit identity: batched = sequential = twin {s['bit_identity_ok']}, "
          f"v4 = v3 {s['v4_v3_bit_identical']}, async = sync "
          f"{all(a['async_bit_identical'] for a in s['async_sweep'].values())}"
          f", concurrent sessions = twin {s['concurrent_bit_identical']}")
    for t in ("twin", "subprocess", "socket"):
        r = s[t]
        print(f"[driver] {t}: probe {1e3 * r['probe_s']:.3f} ms, serve "
              f"{1e3 * r['serve_s']:.3f} ms, readback "
              f"{1e3 * r['readback_s']:.3f} ms, advance "
              f"{1e3 * r['advance_s']:.3f} ms, zo_refine "
              f"{1e3 * r['zo_refine_s']:.2f} ms; batch 1/8/64 a probe "
              + " / ".join(f"{r['batch_sweep'][n]['per_op_ms']:.3f}"
                           for n in ("1", "8", "64")) + " ms")
    for t, a in s["async_sweep"].items():
        print(f"[driver] {t} async depth {a['depth']}: {1e3 * a['sync_s']:.2f}"
              f" ms sync, {1e3 * a['async_s']:.2f} ms async "
              f"({a['overlap_speedup']:.2f}x)")
    c = s["concurrent"]
    print(f"[driver] {c['n_clients']} concurrent socket sessions: "
          f"{c['aggregate_cols_per_s']:.0f} probe columns/s in all; socket "
          f"batch 64 against the twin's {s['socket_batch64_vs_twin_batch64']:.2f}"
          f"x (reference gate {s['v4_socket_batch64_threshold']}); children's "
          f"launches " + ", ".join(
              f"{k}={v}" for k, v in
              sorted(subprocess_driver.server_launch_counts.items())))
    check(s["bit_identity_ok"] and s["v4_v3_bit_identical"]
          and s["concurrent_bit_identical"],
          "driver: a driver_overhead bit-identity check failed")
    check(s["v4_socket_batch64_within_2x_twin"],
          f"driver: socket batch 64 at "
          f"{s['socket_batch64_vs_twin_batch64']:.3f}x the twin's, under the "
          f"reference gate's {s['v4_socket_batch64_threshold']}")
    t0 = time.perf_counter()
    driver_flows(torch)
    print(f"[driver] the three sessions {time.perf_counter() - t0:.1f} s")
    print(f"[driver] phase {time.perf_counter() - t_phase:.1f} s")
    return child


# the e2e_accuracy phase: the port's benchmark at the reference's own
# configuration (smoke:qwen3-4b trained 200 steps, 2 chips of k = 8, every
# PTC layer a tenant), none of it cut: its gates are defined on it.  The
# reference's quick run on a CPU (bench_artifacts/BENCH_e2e_accuracy.json),
# printed beside the card's as readings, not gates
E2E_KERNELS = HW_KERNELS + ("prefill_attention",
                            "prefill_attention_cudacore")


def _e2e_parting_margin(torch, p: dict) -> str:
    """The untrained model's routed run of the identity stream again with
    its logits traced: the top-2 margin at ``p``'s request and position,
    beside the largest logit."""
    import numpy as np
    from repro_torch.benchmarks import e2e_accuracy as ea
    from repro_torch.configs import parse_arch
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import serve

    cfg = parse_arch(ea.ARCH)
    b = ea.BUDGETS["quick"]
    stream = lm_batch(ea.SEED, 999, b["batch"], b["stream_len"],
                      cfg.vocab)["tokens"][:2, :b["conf_len"]]
    args = ea._serve_args(ea._init_params(cfg, "cuda"), stream, 0.0,
                          recal=False, mode="route", trace_logits=True,
                          device="cuda")
    row = serve.run(args)["logits"][p["position"], p["request"]]
    top2 = np.sort(row)[-2:]
    return (f"top-2 margin {top2[1] - top2[0]:.3e} at the largest logit "
            f"{np.abs(row).max():.3e}")


def _zcd_check(torch) -> None:
    """A repair's search at the benchmark's sizes (one 64 x 64 projection:
    64 blocks of k = 8, 200 ZCD steps, post-IC noise): ``phase_refine``,
    which realizes only the moved half's unitary a measurement and replays
    each half's step as a CUDA graph, against ``zo_minimize`` on the whole
    loss, in turns on the card; the same bits and both walls, and the
    launches one search counts (2 + 2 steps meshes, 1 + 2 steps probes)."""
    from repro_torch.benchmarks.common import to_device
    from repro_torch.core import unitary as un
    from repro_torch.core.noise import DEFAULT_NOISE
    from repro_torch.hw import jobs
    from repro_torch.kernels import build
    from repro_torch.hw.device import realized_unitaries, sample_device
    from repro_torch.optim.zo import ZOConfig, zo_minimize

    gen = torch.Generator("cpu").manual_seed(0)
    k, b = HW_FLEET_K, 64
    spec = un.mesh_spec(k, "clements")
    t = spec.n_rot
    model = DEFAULT_NOISE.post_ic()
    dev = to_device(sample_device(gen, (b,), k, model), "cuda")
    phi0 = (torch.rand((b, 2 * t), generator=gen) * 6.28).cuda()
    sigma = (torch.rand((b, k), generator=gen) + 0.5).cuda()
    w = torch.randn((b, k, k), generator=gen).cuda()
    cfg = ZOConfig(steps=200, inner=2 * t, delta0=0.02, decay=1.02)
    draws = jobs.job_draws(gen, "zcd", b, cfg.steps, t).cuda()

    def loss(ph):
        u, v = realized_unitaries(spec, ph[:, :t], ph[:, t:], dev, model)  # repro: noqa[RPL103]
        return jobs._block_distance(jobs.probe_transfer(u, sigma, v), w)

    runs = dict(
        zo_minimize=lambda: zo_minimize(loss, phi0, cfg, "zcd",
                                        alt_split=t, draws=draws),
        phase_refine=lambda: jobs.phase_refine(spec, model, dev, phi0, sigma,
                                               w, None, cfg, "zcd", draws))
    walls, res = {name: [] for name in runs}, {}
    for _ in range(3):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[name] = fn()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    check(all(torch.equal(a, e) for a, e in zip(res["phase_refine"],
                                                res["zo_minimize"])),
          "e2e_accuracy: phase_refine's ZCD is not zo_minimize's bits")
    # the launches a search makes, most of them added at each replay from
    # the capture's tally: the two halves' meshes and one probe at the
    # start, then two of each a step, as the eager loop launches them
    build.reset_launch_counts()
    jobs.phase_refine(spec, model, dev, phi0, sigma, w, None, cfg, "zcd",
                      draws)
    torch.cuda.synchronize()
    got = {k: n for k, n in build.launch_counts.items() if n}
    want = dict(mesh_apply=2 + 2 * cfg.steps,
                ptc_block_matmul_perblock=1 + 2 * cfg.steps)
    check(got == want, f"e2e_accuracy: a repair's search launched {got}, "
                       f"not {want}")
    ms = {name: 1e3 * sorted(v)[1] for name, v in walls.items()}
    print(f"[e2e_accuracy] a repair's search, 64 blocks of k = 8, 200 ZCD "
          f"steps (median of 3, in turns): phase_refine "
          f"{ms['phase_refine']:.1f} ms, zo_minimize on the whole loss "
          f"{ms['zo_minimize']:.1f} ms "
          f"({ms['zo_minimize'] / ms['phase_refine']:.2f}x); the same bits")


def e2e_accuracy_phase(torch) -> dict:
    """The port's e2e_accuracy benchmark at quick on the card through its
    runner: its four gates, its layer and frame counts equal to the
    reference's JSON, the accuracies, alarms and recals beside the
    reference's CPU run, each run's wall, the socket children's start and
    close walls, and the launches in this process and in the transport
    leg's server children.  Returns the benchmark's launches in this
    process (counts set to 0 just before it)."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import ART
    from repro_torch.hw import subprocess_driver
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    info = build.build(sorted({build.KERNELS[k] for k in E2E_KERNELS}))
    if info["built"]:
        print(f"[e2e_accuracy] built {info['built']} in "
              f"{info['seconds']:.1f} s")
    path = ART / "BENCH_e2e_accuracy.json"
    path.unlink(missing_ok=True)
    build.reset_launch_counts()
    subprocess_driver.server_launch_counts.clear()
    try:
        with socket_children() as kids:
            recs = bench_run.run("quick", only="runtime_e2e_accuracy",
                                 device="cuda", benches=bench_run.RUNTIME)
    finally:
        # a failed gate raises inside the benchmark, after its JSON
        if path.exists():
            p = json.loads(path.read_text())["partings"]["route_shadow"]
            if p is not None:
                print(f"[e2e_accuracy] route and shadow part at request "
                      f"{p['request']}, position {p['position']}; "
                      + _e2e_parting_margin(torch, p))
    launches = {k: build.launch_counts[k] for k in build.KERNELS}
    children = dict(subprocess_driver.server_launch_counts)
    s = recs[0]["tables"]["summary"]
    ref = json.loads((Path(__file__).resolve().parent / "bench_artifacts"
                      / "BENCH_e2e_accuracy.json").read_text())
    base, rbase = s["baseline"], ref["baseline"]
    print(f"[e2e_accuracy] quick at {s['arch']}, {s['fleet']} chips of k = "
          f"{s['fleet_k']}, {s['n_ptc_layers']} PTC layers as tenants, "
          f"{s['frames_per_step']} frames a step; the runner's wall "
          f"{recs[0]['seconds']:.1f} s")
    print(f"[e2e_accuracy] training loss after {s['train_steps']} steps "
          f"{s['train_loss']:.4f} (reference, CPU: {ref['train_loss']:.4f})")
    print(f"[e2e_accuracy] sigma 0: accuracy {base['accuracy']:.4f}, tail "
          f"{base['tail_accuracy']:.4f} (reference, CPU: "
          f"{rbase['accuracy']:.4f} / {rbase['tail_accuracy']:.4f})")
    for got, want in zip(s["sweep"], ref["sweep"]):
        for loop in ("closed", "open"):
            g, w = got[loop], want[loop]
            print(f"[e2e_accuracy] sigma {got['sigma']} {loop}: accuracy "
                  f"{g['accuracy']:.4f}, tail {g['tail_accuracy']:.4f}, "
                  f"{g['alarms']} alarms, {g['recals']} recals, max probe "
                  f"distance {g['max_probe_distance']:.4f} (reference, CPU: "
                  f"{w['accuracy']:.4f}, {w['tail_accuracy']:.4f}, "
                  f"{w['alarms']}, {w['recals']}, "
                  f"{w['max_probe_distance']:.4f})")
    print(f"[e2e_accuracy] run walls, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in s["leg_walls_s"].items()))
    for what, walls in kids.items():
        w = sorted(walls)
        print(f"[e2e_accuracy] socket server children, {what}: "
              f"{len(w)}, {sum(w):.1f} s in all (each {w[0]:.2f}-{w[-1]:.2f}"
              f" s; a fleet's two together)"
              if w else f"[e2e_accuracy] no socket server child, {what}")
    print(f"[e2e_accuracy] launches over the benchmark: in this process "
          + ", ".join(f"{k}={v}" for k, v in launches.items() if v)
          + "; in the server children " + ", ".join(
              f"{k}={v}" for k, v in sorted(children.items())))
    check(len(s["gates"]) == 4, f"e2e_accuracy: gates {s['gates']}")
    for name, ok in s["gates"].items():
        check(ok, f"e2e_accuracy: gate {name} is false")
    for key in ("n_ptc_layers", "frames_per_step"):
        check(s[key] == ref[key], f"e2e_accuracy: {key} {s[key]} is not the "
                                  f"reference's {ref[key]}")
    for k in HW_KERNELS:
        check(launches[k] > 0, f"e2e_accuracy: no {k} launched")
        check(children.get(k, 0) > 0,
              f"e2e_accuracy: no {k} launched in the server children")
    _zcd_check(torch)
    print(f"[e2e_accuracy] phase {time.perf_counter() - t_phase:.1f} s")
    return {k: launches[k] for k in E2E_KERNELS}


# the serving_gateway phase: the port's benchmark at the reference's own
# sizes (smoke:qwen3-4b, fp32 bases, head dim 16: the CUDA-core prefill
# route), then check_regression over the JSONs this invocation wrote
SG_KERNELS = HW_KERNELS + ("paged_gather", "paged_scatter",
                           "prefill_attention", "prefill_attention_cudacore")
SG_JSONS = (("serving_gateway", "BENCH_serving_gateway.json"),
            ("e2e_accuracy", "BENCH_e2e_accuracy.json"),
            ("driver", "BENCH_driver_overhead.json"),
            ("hw_serve", "BENCH_fleet_autopilot.json"))


@contextlib.contextmanager
def socket_children():
    """The seconds each ``SocketDriver`` built in the block took to
    construct (its server child's start, the announce and the handshake,
    under ``"start"``) and to close (the child's exit, ``"close"``)."""
    from repro_torch.hw.socket_driver import SocketDriver

    walls = dict(start=[], close=[])
    orig = dict(start=SocketDriver.__init__, close=SocketDriver.close)

    def timed(what):
        def wrapper(self, *a, **kw):
            # a close counts once, while the child is still there
            child = what == "start" or getattr(self, "_proc", None)
            t0 = time.perf_counter()
            orig[what](self, *a, **kw)
            if child is not None:
                walls[what].append(time.perf_counter() - t0)
        return wrapper

    SocketDriver.__init__, SocketDriver.close = timed("start"), timed("close")
    try:
        yield walls
    finally:
        SocketDriver.__init__, SocketDriver.close = orig["start"], \
            orig["close"]


def _parting_margin(torch, request: int, step: int, driver: str) -> str:
    """The sequential run of the throughput (twin) or socket workload's
    ``request`` again with its logits traced: the top-2 margin of the
    logits that chose its token ``step``, beside the largest logit."""
    import numpy as np
    from repro_torch.benchmarks import serving_gateway as sg
    from repro_torch.configs import parse_arch
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_model

    cfg = parse_arch(sg.ARCH)
    params = init_model(torch.Generator("cuda").manual_seed(0), cfg)
    wl = sg.workloads("quick", cfg.vocab)
    req = wl["throughput" if driver == "twin" else "socket"][request]
    args = sg._seq_args(params, req, "cuda", driver=driver)
    args.trace_logits = True
    row = serve.run(args)["logits"][req.prompt_len - 1 + step, 0]
    top2 = np.sort(row)[-2:]
    return (f"top-2 margin {top2[1] - top2[0]:.3e} at the largest logit "
            f"{np.abs(row).max():.3e}")


def _sg_partings(torch, s: dict) -> None:
    """Where each token-identity check's runs part, with the sequential
    side's top-2 margin there (a near tie, or a fault)."""
    for leg, p in s["partings"].items():
        if p is None:
            continue
        where = f"request {p['request']}, decode step {p['step']}"
        if leg in ("throughput", "socket"):
            where += "; " + _parting_margin(
                torch, p["request"], p["step"],
                "twin" if leg == "throughput" else "socket")
        print(f"[serving_gateway] {leg}: tokens part at {where}")


def serving_gateway_phase(torch, phases: list) -> dict:
    """The port's serving_gateway benchmark at quick on the card through
    its runner (its nine gates, its virtual-step metrics equal to the
    reference's JSON), then check_regression over the JSONs of this
    invocation's phases, plain and ``--self-test``.  Returns the
    benchmark's launches in this process (counts set to 0 just before
    it)."""
    import shutil
    import tempfile
    from repro_torch.benchmarks import check_regression as cr
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import ART
    from repro_torch.hw import subprocess_driver
    from repro_torch.kernels import build

    t_phase = time.perf_counter()
    info = build.build(sorted({build.KERNELS[k] for k in SG_KERNELS}))
    if info["built"]:
        print(f"[serving_gateway] built {info['built']} in "
              f"{info['seconds']:.1f} s")
    path = ART / "BENCH_serving_gateway.json"
    path.unlink(missing_ok=True)
    build.reset_launch_counts()
    subprocess_driver.server_launch_counts.clear()
    try:
        with socket_children() as kids:
            recs = bench_run.run("quick", only="serving_gateway",
                                 device="cuda", benches=bench_run.RUNTIME)
    finally:
        # a failed gate raises inside the benchmark, after its JSON
        if path.exists():
            _sg_partings(torch, json.loads(path.read_text()))
    launches = {k: build.launch_counts[k] for k in SG_KERNELS}
    s = recs[0]["tables"]["summary"]
    ref = json.loads((Path(__file__).resolve().parent / "bench_artifacts"
                      / "BENCH_serving_gateway.json").read_text())
    seq, gw, pre = s["sequential"], s["gateway"], s["prefill"]
    print(f"[serving_gateway] quick at {s['arch']}, {s['fleet']} chips of "
          f"k = 8, {s['slots']} slots, {s['n_requests']} requests; the "
          f"runner's wall {recs[0]['seconds']:.1f} s")
    print(f"[serving_gateway] sequential {seq['tokens']} tokens in "
          f"{seq['wall_s']:.3f} s: {seq['tokens_per_s_per_chip']:.2f} tokens/s"
          f" a chip; gateway {gw['tokens']} in {gw['wall_s']:.3f} s: "
          f"{gw['tokens_per_s_per_chip']:.2f}; speedup "
          f"{s['tokens_per_chip_speedup']:.2f}x (reference, CPU: "
          f"{ref['tokens_per_chip_speedup']:.2f}x)")
    print(f"[serving_gateway] gateway {gw['steps']} steps, occupancy "
          f"{gw['occupancy']:.3f} of {s['slots']}, "
          f"{gw['frames_per_step']:.1f} frames a step")
    print(f"[serving_gateway] TTFT p50 / p99 in steps: " + ", ".join(
        f"C = {c} {pre['ttft'][c]['p50']} / {pre['ttft'][c]['p99']}"
        for c in ("1", "8", "32"))
        + f"; twin frames C = 1 {pre['twin']['frames_c1']}, C = 8 "
          f"{pre['twin']['frames_c8']} ({pre['twin']['cols_per_frame_c1']:.2f}"
          f" and {pre['twin']['cols_per_frame_c8']:.2f} columns a frame)")
    rr, d = s["ref_rate"], s["drift"]
    print(f"[serving_gateway] rate {rr['rate']}: latency p50 "
          f"{rr['p50_latency_steps']} p99 {rr['p99_latency_steps']} steps; "
          f"drift sigma {d['sigma']}: {d['tokens_out']} tokens, "
          f"{d['alarms']} alarms, {d['recals']} recals")
    print(f"[serving_gateway] leg walls, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in s["leg_walls_s"].items()))
    for what, walls in kids.items():
        w = sorted(walls)
        print(f"[serving_gateway] socket server children, {what}: "
              f"{len(w)}, {sum(w):.1f} s in all (each {w[0]:.2f}-{w[-1]:.2f}"
              f" s, median {w[len(w) // 2]:.2f}; a fleet's two together)"
              if w else f"[serving_gateway] no socket server child, {what}")
    print(f"[serving_gateway] launches over the benchmark: in this process "
          + ", ".join(f"{k}={v}" for k, v in launches.items())
          + "; in the server children " + ", ".join(
              f"{k}={v}" for k, v in
              sorted(subprocess_driver.server_launch_counts.items())))
    check(len(s["gates"]) == 9, f"serving_gateway: gates {s['gates']}")
    for name, ok in s["gates"].items():
        check(ok, f"serving_gateway: gate {name} is false")
    for key in ("load_sweep", "ref_rate"):
        check(s[key] == ref[key], f"serving_gateway: {key} {s[key]} is not "
                                  f"the reference's {ref[key]}")
    for key in ("ttft", "busy_steps"):
        check(pre[key] == ref["prefill"][key],
              f"serving_gateway: prefill {key} {pre[key]} is not the "
              f"reference's {ref['prefill'][key]}")
    print("[serving_gateway] virtual-step metrics (prefill TTFT and busy "
          "steps, the load sweep, the rate-2.0 latencies) equal the "
          "reference's JSON")
    for k in ("paged_gather", "paged_scatter"):
        check(launches[k] > 0, f"serving_gateway: no {k} launched")
    check(launches["prefill_attention"] + launches[
        "prefill_attention_cudacore"] > 0,
          "serving_gateway: no prefill attention launched")
    for k in HW_KERNELS:
        check(launches[k] + subprocess_driver.server_launch_counts[k] > 0,
              f"serving_gateway: no {k} launched")

    # check_regression over this invocation's JSONs: the plain check
    # against an empty baseline (gates checked, metrics skipped), then the
    # self-test against a copy of them (the degraded copy must fail)
    require = [f for phase, f in SG_JSONS if phase in phases]
    with tempfile.TemporaryDirectory() as tmp:
        cur, empty = Path(tmp) / "current", Path(tmp) / "empty"
        cur.mkdir()
        empty.mkdir()
        for f in require:
            shutil.copy(ART / f, cur / f)
        shutil.copytree(cur, Path(tmp) / "baseline")
        argv = ["--current", str(cur), "--require", *require]
        rc = cr.main(["--baseline", str(empty), *argv])
        check(rc == 0, f"serving_gateway: check_regression failed over "
                       f"{require}")
        rc = cr.main(["--baseline", str(Path(tmp) / "baseline"), *argv,
                      "--self-test"])
        check(rc == 0, "serving_gateway: check_regression's self-test "
                       "passed the degraded copy")
        for f in require:
            got = json.loads((cur / f).read_text())
            want = json.loads((Path(__file__).resolve().parent
                               / "bench_artifacts" / f).read_text())
            print(f"[serving_gateway] {f}: " + ", ".join(
                f"{name} {float(fn(got)):.4f} ({float(fn(want)):.4f})"
                for name, fn in cr.SPECS[f]["metrics"].items())
                + " (reference, CPU, in brackets: a reading, not a gate)")
    print(f"[serving_gateway] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout (say a git archive of the "
                         "parent commit): its ptc_block_matmul.cu, "
                         "sigma_grad.cu and prefill_attn.cu are built and "
                         "timed beside this tree's kernels in the kernels "
                         "phase")
    # quick keeps every phase inside half the run's time limit: at normal
    # the tables phase alone took 548.9 s on an H100 (Table 4's 163,520
    # ZCD steps at about 3 ms each), at quick Table 4 is 25,000 steps
    ap.add_argument("--budget", default="quick",
                    choices=["quick", "normal"],
                    help="the tables phase's budget (the benchmarks')")
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

    t_lap = [t_start]

    def lap(names: str) -> None:
        """Print the wall of the phase(s) ``names`` just ended, if run."""
        now = time.perf_counter()
        if any(n in phases for n in names.split(",")):
            print(f"[wall] {names}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    # the kernels' build (nvcc on the host) overlaps qwen3-4b's seeded init
    # (cuSOLVER on the card, no kernel of the port): about 40 s each
    building = qwen = None
    if "kernels" in phases:
        building = concurrent.futures.ThreadPoolExecutor(1).submit(
            build.build, None, True)
        if "gateway" in phases or "serve" in phases:
            qwen = staged_qwen3_4b_params(torch)
    summary = kernel_phase(torch, args.parent, building) \
        if "kernels" in phases else {}
    # launches of each kernel on its main path in this run: the last
    # quickstart path driven (full width, else parity, else the tables) for
    # the PTC kernels, one olmo-1b update step of the train phase for the
    # tensor-core routes (else the blocked_lm bf16 step), the blocked_lm
    # fp32 step and realization for the other wide routes, the gateway for
    # the serving kernels; null where none was driven
    launches = dict.fromkeys(build.KERNELS)

    lap("kernels")
    if "parity" in phases:
        res, counts = main_path(torch, "parity", (18, 18, 9, 9))
        launches.update(counts)
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
        ptc_bridge_check(torch)

    lap("parity")
    if "full" in phases:
        # input noise 6 (not the parity run's 0.8) keeps the 4096-wide
        # task from being trivially separable: dense held-out accuracy
        # is about 0.9, so the served accuracy can show a mapping loss
        res, counts = main_path(torch, "full", (4096, 512, 10, 9),
                                noise=6.0, serve_batches=8, serve_rows=1024)
        launches.update(counts)
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

    lap("full")
    if "closed_loop" in phases:
        counts = closed_loop_phase(
            torch, res["weights"] if "full" in phases else None)
        # a quickstart path driven in this run keeps its counts
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})

    lap("closed_loop")
    hw = None
    if "hw_serve" in phases:
        counts, hw = hw_serve_phase(torch)
        # a quickstart path driven in this run keeps its counts
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})
        if "driver" not in phases:
            hw = None

    lap("hw_serve")
    if "driver" in phases:
        counts = driver_phase(torch, hw)
        # the server children's launches over leg A, where no earlier
        # path of this run counted the kernel
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})
        hw = None

    lap("driver")
    if "vgg8" in phases:
        vgg8_phase(torch)

    lap("vgg8")
    if "blocked_lm" in phases:
        launches.update(blocked_lm_phase(torch))

    lap("blocked_lm")
    if "train" in phases:
        launches.update(train_phase(torch))

    lap("train")
    if "examples" in phases:
        examples_phase(torch)

    lap("examples")
    if "gateway" in phases or "serve" in phases:
        if qwen is None:
            params = qwen3_4b_params(torch)
        else:
            from repro_torch.models.layers import tree_map
            params = tree_map(lambda t: t.to("cuda"), qwen)
            del qwen
        if "gateway" in phases:
            launches.update(gateway_phase(torch, params))
        if "serve" in phases:
            serve_phase(torch, params)
        del params
        torch.cuda.empty_cache()

    lap("gateway,serve")
    if "families" in phases:
        families_phase(torch)

    lap("families")
    if "tables" in phases:
        counts = tables_phase(torch, args.budget)
        # a quickstart path driven in this run keeps its counts
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})

    lap("tables")
    if "e2e_accuracy" in phases:
        counts = e2e_accuracy_phase(torch)
        # the benchmark's launches, where no earlier path of this run
        # counted the kernel
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})

    lap("e2e_accuracy")
    if "serving_gateway" in phases:
        counts = serving_gateway_phase(torch, phases)
        # the benchmark's launches, where no earlier path of this run
        # counted the kernel
        launches.update({k: v for k, v in counts.items()
                         if launches[k] is None})

    lap("serving_gateway")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)                     # name, power limit: as nvidia-smi has it
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda",
             source="src/repro_torch/csrc/"
                    + build.SOURCES[build.KERNELS[name]],
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
