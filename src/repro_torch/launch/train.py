"""End-to-end LM training driver: subspace learning of Σ at LM scale.

Counterpart of ``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smoke:olmo-1b \\
        --device cpu --steps 50 --batch 8 --seq 64

Without ``--device`` it runs on ``cuda`` (and refuses a host without
CUDA).  The reference's flags, with their meanings: periodic and SIGTERM
checkpoints with resume from the latest (``--ckpt-dir``,
``--ckpt-every``), SMD data sampling (``--alpha-d``: skip an iteration
with that probability), a per-step deadline whose late steps are logged
(``--deadline-ms``), and feedback / column sampling (``--alpha-w``,
``--alpha-c``).  The step's randomness (the SMD draw and the masks) comes
from a generator seeded by (seed, step), so a resumed run draws what the
uninterrupted run would have.  The reference's int8 gradient compression
for a data-parallel all-reduce has no counterpart on one card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs import parse_arch
from ..core.sparsity import SparsityConfig, smd_keep_iteration
from ..data.synthetic import lm_batch
from ..device import resolve_device
from ..optim.optimizers import AdamWConfig
from ..optim.schedules import linear_warmup_cosine
from .steps import build_update_step, init_train_state

__all__ = ["arg_parser", "train", "main"]


def arg_parser() -> argparse.ArgumentParser:
    """The driver's command line (the reference's flags and ``--device``)."""
    ap = argparse.ArgumentParser(description="LM subspace-learning driver "
                                             "(PyTorch port)")
    ap.add_argument("--arch", required=True,
                    help="arch id, or smoke:<id> for the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--alpha-w", type=float, default=1.0)
    ap.add_argument("--alpha-c", type=float, default=1.0)
    ap.add_argument("--alpha-d", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-step deadline; late steps are logged")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def _batch(args, step: int, vocab: int, dev) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
            for k, v in lm_batch(args.seed, step, args.batch, args.seq,
                                 vocab).items()}


def train(args) -> dict:
    """Run the training loop of ``args`` (the CLI's namespace; ``arch``
    may be an ``ArchConfig``).  Returns ``losses`` (one per step run),
    ``steps_run``, ``skipped`` (SMD), ``resumed_from`` (a checkpoint's
    step or None), ``late`` (steps past the deadline) and ``wall_s``."""
    dev = resolve_device(args.device)
    cfg = args.arch if not isinstance(args.arch, str) else \
        parse_arch(args.arch)
    scfg = SparsityConfig(alpha_w=args.alpha_w, alpha_c=args.alpha_c,
                          alpha_d=args.alpha_d)
    ocfg = AdamWConfig(lr=args.lr)
    params, opt_state = init_train_state(
        torch.Generator(dev).manual_seed(args.seed), cfg)
    step0, resumed = 0, None
    mgr = None
    try:
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
            restored, meta = mgr.restore_or_none((params, opt_state))
            if restored is not None:
                params, opt_state = restored
                resumed = int(meta["step"])
                step0 = resumed + 1
                print(f"resumed from step {resumed}")

        update = build_update_step(
            cfg, ocfg, scfg, lambda step: linear_warmup_cosine(step, 10,
                                                               args.steps))
        losses, skipped, late = [], 0, []
        t_train0 = time.perf_counter()
        for step in range(step0, args.steps):
            gen = torch.Generator(dev).manual_seed(
                args.seed * 1_000_003 + step)
            # SMD: data-level sparsity, the whole iteration skipped w.p. α_D
            if scfg.alpha_d > 0 and not smd_keep_iteration(gen, scfg):
                skipped += 1
                continue
            batch = _batch(args, step, cfg.vocab, dev)
            t0 = time.perf_counter()
            params, opt_state, loss, gnorm = update(params, opt_state, batch,
                                                    gen)
            loss = float(loss)          # waits for the step's device work
            dt = (time.perf_counter() - t0) * 1e3
            if args.deadline_ms and dt > args.deadline_ms:
                late.append(step)
                print(f"step {step}: DEADLINE exceeded ({dt:.0f}ms "
                      f"> {args.deadline_ms}ms) — straggler logged")
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step}: loss={loss:.4f} gnorm={float(gnorm):.3f} "
                      f"({dt:.0f}ms)", flush=True)
            if mgr is not None:
                mgr.maybe_save(step, (params, opt_state), {"loss": loss})
                if mgr.preempted:
                    print(f"SIGTERM: checkpointed at step {step}, exiting")
                    break
    finally:
        if mgr is not None:
            mgr.close()     # SIGTERM goes back to its old handler
    wall = time.perf_counter() - t_train0
    if losses:
        print(f"done: first-10 mean loss {np.mean(losses[:10]):.4f} → "
              f"last-10 mean {np.mean(losses[-10:]):.4f} ({wall:.0f}s)")
    else:
        print(f"done: no step ran ({skipped} skipped by SMD)")
    return dict(losses=losses, steps_run=len(losses), skipped=skipped,
                resumed_from=resumed, late=late, wall_s=wall)


def main(argv=None) -> int:
    train(arg_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
