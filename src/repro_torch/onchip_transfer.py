"""Paper Fig. 14: in-situ transferability of the restricted subspace.

    PYTHONPATH=src python -m repro_torch.onchip_transfer            # on the card
    PYTHONPATH=src python -m repro_torch.onchip_transfer --device cpu

Counterpart of ``examples/onchip_transfer.py``: pre-train a dense
36 → 36 → 9 MLP on task A, MAP it onto the chip (PM without the ZO
search: the inherited unitaries now encode task-A structure), then adapt
to the related task B by training Σ ONLY through the blocked
``ptc_linear`` (forward: the PTC kernel; backward: the ``sigma_grad`` and
``feedback_matmul`` kernels), in three runs: inherited bases with the
inherited Σ, inherited bases with Σ re-drawn, and random bases from
scratch.  The reference's jax keys (10 + i, 33, 34, 70, 71) are torch
generators seeded with the same numbers here; ``draws`` can hand in the
reference's own draws instead.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .core.mapping import parallel_map
from .core.noise import NoiseModel
from .core.ptc import PTCParams, random_factorize
from .core.subspace import ptc_linear
from .data import synthetic_vision, transfer_vision
from .device import resolve_device
from .kernels import build
from .optim.optimizers import AdamWConfig, apply_updates, init_opt_state

__all__ = ["D", "H", "C", "K", "NOISE", "sigma_loss", "accuracy",
           "train_sigma", "run", "main"]

D, H, C, K = 36, 36, 9, 9
NOISE = 2.2
CURVES = ("transfer", "transfer_bases", "scratch")


def _logits(s: list, layers: list, x: torch.Tensor) -> torch.Tensor:
    ps = [PTCParams(layers[i].u, s[i], layers[i].v) for i in range(2)]
    h = torch.relu(ptc_linear(x, ps[0], mode="blocked"))
    return ptc_linear(h, ps[1], mode="blocked")[:, :C]


def _xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.logsumexp(logits, -1)
                      - logits.gather(-1, y[:, None].long())[:, 0])


def sigma_loss(s: list, layers: list, x, y) -> torch.Tensor:
    """Mean cross-entropy of the two-layer PTC MLP with singular values
    ``s`` on the bases of ``layers``."""
    return _xent(_logits(s, layers, x), y)


def accuracy(s: list, layers: list, x, y) -> float:
    with torch.no_grad():
        return float((_logits(s, layers, x).argmax(-1) == y).float().mean())


def train_sigma(layers: list, s: list, x, y, xe, ye, steps: int,
                lr: float = 4e-3, eval_every: int = 20, keep: int = 10):
    """AdamW on Σ only for ``steps`` steps, the held-out accuracy every
    ``eval_every`` steps and at the end.  Returns (Σ, curve [(step,
    accuracy)], each step's loss, Σ after ``keep`` steps)."""
    s = [t.detach() for t in s]
    opt = init_opt_state(s)
    ocfg = AdamWConfig(lr=lr)
    curve, losses, kept = [], [], None
    for i in range(steps):
        if i % eval_every == 0:
            curve.append((i, accuracy(s, layers, xe, ye)))
        sv = [t.requires_grad_(True) for t in s]
        loss = sigma_loss(sv, layers, x, y)
        grads = torch.autograd.grad(loss, sv)
        s, opt, _ = apply_updates([t.detach() for t in sv], list(grads), opt,
                                  ocfg)
        losses.append(float(loss.detach()))
        if i + 1 == keep:
            kept = [t.clone() for t in s]
    curve.append((steps, accuracy(s, layers, xe, ye)))
    return s, curve, losses, kept


def _pretrain(x, y, steps: int, device) -> list:
    """Dense pre-training on task A: 250 AdamW steps at lr 5e-3 from the
    reference's numpy-seeded weights."""
    rng = np.random.default_rng(0)
    ws = [torch.as_tensor((rng.standard_normal(shape) * 0.4).astype(
              np.float32), device=device) for shape in ((H, D), (C, H))]
    opt = init_opt_state(ws)
    ocfg = AdamWConfig(lr=5e-3)
    for _ in range(steps):
        wv = [w.requires_grad_(True) for w in ws]
        loss = _xent(torch.relu(x @ wv[0].T) @ wv[1].T, y)
        grads = torch.autograd.grad(loss, wv)
        ws, opt, _ = apply_updates([w.detach() for w in wv], list(grads),
                                   opt, ocfg)
    return ws


def run(device=None, steps: int = 240, pretrain_steps: int = 250,
        draws: dict | None = None, log=print) -> dict:
    """The Fig. 14 experiment on ``device``.

    ``draws`` (each entry optional) replaces this run's own: ``dense``,
    the two task-A weights to map; ``dev``, the two layers' device
    realizations for PM; ``sigma``, the two re-drawn Σ; ``scratch``, the
    two random ``PTCParams`` of the scratch run.  Returns the task-A
    mapped accuracy (``mapped_acc``), the three ``curves`` and their
    per-step ``losses``, Σ after each run's first 10 steps (``sigma10``),
    the pre-trained ``dense`` weights and each stage's wall seconds and
    kernel launches (``stages``)."""
    device = resolve_device(device)
    draws = draws or {}
    stages = {}

    def stage(name, fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        before = dict(build.launch_counts)
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stages[name] = dict(
            seconds=time.perf_counter() - t0,
            launches={k: n - before[k] for k, n in build.launch_counts.items()
                      if n != before[k]})
        return out

    def tensors(batch):
        return (torch.as_tensor(batch["x"], device=device),
                torch.as_tensor(batch["y"], device=device).long())

    # ---- task A: dense pre-training
    xa, ya = tensors(synthetic_vision(1, 0, 1024, (D,), C, noise=NOISE))
    dense = stage("pretrain", lambda: _pretrain(xa, ya, pretrain_steps,
                                                device))
    ws = [torch.as_tensor(w, dtype=torch.float32, device=device)
          for w in draws.get("dense", dense)]

    # ---- map task-A weights onto the chip (bases inherit A's structure)
    post = NoiseModel().post_ic()

    def pm():
        out = []
        for i in range(2):
            dev = draws["dev"][i] if "dev" in draws else None
            gen = None if dev is not None else \
                torch.Generator(device).manual_seed(10 + i)
            out.append(parallel_map(gen, ws[i], K, post, run_zo=False,
                                    dev=dev, device=device).params)
        return out

    pm_a = stage("pm", pm)
    mapped_acc = stage("eval_a", lambda: accuracy(
        [p.s for p in pm_a], pm_a, xa, ya))
    log(f"task A mapped accuracy: {mapped_acc:.3f}")

    # ---- task B data
    xb, yb = tensors(transfer_vision(1, 0, 1024, (D,), C, noise=NOISE))
    xbe, ybe = tensors(transfer_vision(1, 7, 768, (D,), C, noise=NOISE))

    def factors(seeds, m_n):
        return [random_factorize(torch.Generator(device).manual_seed(seed),
                                 m, n, K) for seed, (m, n) in zip(seeds, m_n)]

    shapes = ((H, D), (C, H))
    # transfer A: inherited (mapped) bases + inherited Σ; transfer B:
    # inherited bases, Σ re-drawn; scratch: random bases and Σ
    sigma_b = draws.get("sigma") or [r.s for r in factors((33, 34), shapes)]
    scratch = draws.get("scratch") or factors((70, 71), shapes)
    runs = {"transfer": (pm_a, [p.s for p in pm_a]),
            "transfer_bases": (pm_a, sigma_b),
            "scratch": (scratch, [p.s for p in scratch])}
    curves, losses, sigma10 = {}, {}, {}
    for name, (layers, s0) in runs.items():
        s0 = [torch.as_tensor(s, dtype=torch.float32, device=device)
              for s in s0]
        _, curves[name], losses[name], sigma10[name] = stage(
            name, lambda: train_sigma(layers, s0, xb, yb, xbe, ybe, steps))

    log("\nstep, transferAΣ, transfer_bases, scratch")
    for (i, at), (_, ab), (_, asr) in zip(*(curves[n] for n in CURVES)):
        log(f"{i:4d}, {at:.3f}, {ab:.3f}, {asr:.3f}")
    log(f"\nfinal: inherited-bases+Σ {curves['transfer'][-1][1]:.3f} | "
        f"inherited-bases (Σ re-init) {curves['transfer_bases'][-1][1]:.3f}"
        f" | scratch {curves['scratch'][-1][1]:.3f}")
    return dict(mapped_acc=mapped_acc, curves=curves, losses=losses,
                sigma10=sigma10, dense=dense, stages=stages)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Fig. 14: on-chip transfer "
                                             "(PyTorch port)")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    run(args.device, steps=args.steps)
    print("paper Fig. 14 claim (transfer > scratch) holds through the "
          "BASES; see the Σ-re-init row — the Σ basin is the caveat.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
