"""End-to-end LM training on the PTC substrate.

    # ~100M-parameter model, a few hundred steps, on the card:
    PYTHONPATH=src python -m repro_torch.train_lm --preset 100m --steps 300

    # tiny sanity run on the host:
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu --preset tiny

Counterpart of ``examples/train_lm.py``, through the port's public API end
to end: ``ArchConfig`` → ``init_train_state`` → ``build_update_step``
(sampled in-situ Σ gradients with ``--alpha-w`` < 1, AdamW on the trainable
partition, linear warm-up then cosine) → checkpointed training on the
synthetic Markov LM task.  The loss should fall from about ln(vocab)
toward the task's entropy floor, about ln 4.  The presets keep the fused
PTC mode without remat, as the reference's do, so no CUDA kernel of the
port runs on this path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .core.sparsity import SparsityConfig
from .data import lm_batch
from .device import resolve_device
from .launch.steps import (build_update_step, flatten, init_train_state)
from .models.layers import PTCLinearCfg
from .models.lm import ArchConfig, model_trainable_mask
from .optim.optimizers import AdamWConfig, init_opt_state
from .optim.schedules import linear_warmup_cosine

__all__ = ["PRESETS", "arch", "run", "main"]

PRESETS = {
    # ~100M params: 8L, d=640, ff=2560, vocab 8192 (PTC k=64, fused)
    "100m": dict(n_layers=8, d_model=640, n_heads=10, n_kv_heads=5,
                 head_dim=64, d_ff=2560, vocab=8192, k=64,
                 batch=4, seq=128),
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 head_dim=32, d_ff=512, vocab=512, k=16,
                 batch=8, seq=64),
}


def arch(preset: str) -> ArchConfig:
    """The preset's dense decoder: fused PTC linears with fp32 bases, no
    remat."""
    p = PRESETS[preset]
    return ArchConfig(
        name=f"lm-{preset}", family="dense",
        n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
        n_kv_heads=p["n_kv_heads"], head_dim=p["head_dim"], d_ff=p["d_ff"],
        vocab=p["vocab"], remat=False,
        ptc=PTCLinearCfg(k=p["k"], mode="fused", base_dtype=torch.float32))


def run(preset: str = "tiny", steps: int = 60, lr: float = 3e-3,
        alpha_w: float = 1.0, ckpt_dir: str | None = None, device=None,
        params: dict | None = None, log_every: int = 10) -> dict:
    """Train the preset for ``steps`` steps on ``lm_batch(0, step, ...)``.

    ``params`` (the preset's tree on ``device``) replaces the seeded
    initialization.  Each step's masks come from a generator seeded by the
    step.  Returns ``losses``, ``gnorms`` and ``step_s`` (each step's wall
    seconds, its loss read back), ``n_params`` and ``wall_s``."""
    dev = resolve_device(device)
    cfg = arch(preset)
    p = PRESETS[preset]
    if params is None:
        params, opt_state = init_train_state(
            torch.Generator(dev).manual_seed(0), cfg)
    else:
        opt_state = init_opt_state(flatten(params),
                                   flatten(model_trainable_mask(params)))
    n_params = sum(t.numel() for t in flatten(params))
    # U/V store twice the dense weight
    print(f"model: {n_params / 1e6:.1f}M stored params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    scfg = SparsityConfig(alpha_w=alpha_w) if alpha_w < 1.0 else None
    update = build_update_step(
        cfg, AdamWConfig(lr=lr), scfg,
        lambda s: linear_warmup_cosine(s, 20, steps))
    mgr = CheckpointManager(ckpt_dir, every=100) if ckpt_dir else None

    losses, gnorms, step_s = [], [], []
    t0 = time.perf_counter()
    try:
        for step in range(steps):
            t_step = time.perf_counter()
            batch = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
                     for k, v in lm_batch(0, step, p["batch"], p["seq"],
                                          cfg.vocab).items()}
            gen = torch.Generator(dev).manual_seed(1_000_003 + step)
            params, opt_state, loss, gnorm = update(params, opt_state, batch,
                                                    gen)
            losses.append(float(loss))
            gnorms.append(float(gnorm))
            step_s.append(time.perf_counter() - t_step)
            if step % log_every == 0:
                dt = (time.perf_counter() - t0) / (step + 1)
                print(f"step {step:4d}: loss={losses[-1]:.4f} "
                      f"gnorm={gnorms[-1]:.2f} ({dt:.2f}s/step)", flush=True)
            if mgr is not None:
                mgr.maybe_save(step, (params, opt_state),
                               {"loss": losses[-1]})
    finally:
        if mgr is not None:
            mgr.close()
    wall = time.perf_counter() - t0
    print(f"\nfirst-10 mean loss {np.mean(losses[:10]):.4f} → "
          f"last-10 mean {np.mean(losses[10:][-10:]):.4f} "
          f"(uniform={np.log(cfg.vocab):.2f}, task floor≈{np.log(4):.2f})")
    return dict(losses=losses, gnorms=gnorms, step_s=step_s,
                n_params=n_params, wall_s=wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LM training on the PTC "
                                             "substrate (PyTorch port)")
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--alpha-w", type=float, default=1.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    run(args.preset, args.steps, args.lr, args.alpha_w, args.ckpt_dir,
        args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
