"""Paper Tables 3, 4, 5: block-size (k) sweeps.

* Table 3 — noise-induced relative matrix error vs k (Q/Γ/Ω on a mapped
  72 × 72 weight, commanded-SVD parametrization, post-IC frame);
* Table 4 — IC solution quality (MSE) vs k;
* Table 5 — subspace-learning accuracy vs k (reduced-budget synthetic
  classification; the paper's trend — larger k ⇒ smaller trainable
  subspace ⇒ accuracy drop — is the claim under test).

Counterpart of ``benchmarks/blocksize_tables.py``.  On the card Tables 3
and 4 run the narrow ``mesh_apply`` kernel and the per-block
``ptc_block_matmul`` route at every k of the sweep (k = 12 and 24 inside
the compiled k = 16 and 32 instances); Table 5 trains in fused mode, plain
PyTorch as in the reference (no TPU kernel computes it).  Device
realizations, ZO draws and random factorizations are made on the host
(``draw_*``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core import unitary as un
from ..core.calibration import calibrate_identity
from ..core.mapping import parallel_map
from ..core.noise import NoiseModel
from ..core.ptc import PTCParams, random_factorize
from ..core.subspace import ptc_linear
from ..data.synthetic import synthetic_vision
from ..device import resolve_device
from ..hw.device import sample_device
from ..optim.optimizers import AdamWConfig, apply_updates, init_opt_state
from ..optim.zo import ZOConfig
from .common import cpu_generator, emit, to_device, zo_draws

__all__ = ["PAPER_T3", "PAPER_T4", "PAPER_T5", "block_sizes",
           "t3_weight", "draw_t3", "table3", "t4_config", "draw_t4",
           "table4", "T5", "t5_data", "draw_t5", "train_sigma", "t5_accuracy",
           "table5", "main"]

PAPER_T3 = {8: 0.025, 9: 0.032, 12: 0.043, 16: 0.061, 24: 0.094, 32: 0.126}
PAPER_T4 = {8: 0.0135, 9: 0.013, 12: 0.03, 16: 0.039, 24: 0.04, 32: 0.045}
PAPER_T5 = {8: 84.26, 9: 84.45, 12: 83.36, 16: 81.27, 24: 80.68, 32: 78.40}


def block_sizes(budget: str) -> list[int]:
    return [8, 9, 12, 16] if budget == "quick" else [8, 9, 12, 16, 24, 32]


def _n_blocks(size: int, k: int) -> int:
    return (-(-size // k)) ** 2


# -- Table 3 ------------------------------------------------------------------


def t3_weight(size: int = 72, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((size, size)) * 0.3).astype(np.float32))


def draw_t3(gen: torch.Generator, ks, size: int = 72) -> dict:
    """One post-IC device realization per k."""
    model = NoiseModel().post_ic()
    return {k: sample_device(gen, (_n_blocks(size, k),), k, model)
            for k in ks}


def table3(w: torch.Tensor, devs: dict, device) -> list[list]:
    """Rows [k, rel_err, paper]: ‖W−W̃‖/‖W‖ after the commanded-SVD
    deployment and OSP, without ZO; unrounded."""
    rows = []
    model = NoiseModel().post_ic()
    for k, dev in devs.items():
        pm = parallel_map(None, w, k, model, run_zo=False, dev=dev,
                          device=device)
        # sqrt of the normalized squared distance = the paper's rel err
        rows.append([k, float(torch.sqrt(pm.err_osp.mean())),
                     PAPER_T3.get(k, "")])
    return rows


# -- Table 4 ------------------------------------------------------------------


def t4_config(k: int, budget: str) -> ZOConfig:
    t = k * (k - 1) // 2
    steps = (25 if budget == "quick" else 40) * t
    return ZOConfig(steps=steps, inner=2 * t, delta0=0.5, decay=1.05)


def draw_t4(gen: torch.Generator, cfgs: dict, n_blocks: int = 4,
            restarts: int = 4) -> dict:
    """Per k of ``cfgs`` ({k: ZOConfig}): a device realization of
    ``n_blocks`` blocks and ZCD's per-restart coordinate draws (restarts,
    blocks, steps)."""
    model = NoiseModel()
    out = {}
    for k, cfg in cfgs.items():
        n = 2 * un.mesh_spec(k, "clements").n_rot
        out[k] = (sample_device(gen, (n_blocks,), k, model),
                  zo_draws(gen, "zcd", (restarts, n_blocks, cfg.steps), n))
    return out


def table4(draws: dict, cfgs: dict, device) -> list[list]:
    """Rows [k, IC identity MSE, paper] (ZCD over ``draws``' blocks and
    restarts); unrounded."""
    rows = []
    for k, (dev, zo) in draws.items():
        res = calibrate_identity(None, zo.shape[1], k, NoiseModel(),
                                 cfg=cfgs[k], dev=dev, restarts=zo.shape[0],
                                 device=device, draws=zo)
        mse = (float(res.mse_u.mean()) + float(res.mse_v.mean())) / 2
        rows.append([k, mse, PAPER_T4.get(k, "")])
    return rows


# -- Table 5 ------------------------------------------------------------------

T5 = dict(d=96, n_cls=8, steps=250, quick_steps=120, lr=5e-3)


def t5_data(d: int = T5["d"], n_cls: int = T5["n_cls"]):
    """(x, y, x_test, y_test) as numpy: the reference's synthetic task."""
    tr = synthetic_vision(3, 0, 1024, (d,), n_cls, noise=1.2)
    te = synthetic_vision(3, 1, 512, (d,), n_cls, noise=1.2)
    return tr["x"], tr["y"], te["x"], te["y"]


def draw_t5(gen: torch.Generator, ks, d: int = T5["d"],
            n_cls: int = T5["n_cls"]) -> dict:
    """Per k: the two layers' random factorizations (d → d, d → n_cls
    padded to at least one block)."""
    return {k: (random_factorize(gen, d, d, k),
                random_factorize(gen, max(n_cls, k), d, k)) for k in ks}


def _pad_to(xb: torch.Tensor, params: PTCParams) -> torch.Tensor:
    q = params.grid[1] * params.k
    return F.pad(xb, (0, q - xb.shape[1]))


def _logits(p1: PTCParams, p2: PTCParams, xb: torch.Tensor,
            n_cls: int) -> torch.Tensor:
    h = torch.relu(ptc_linear(_pad_to(xb, p1), p1, mode="fused"))
    return ptc_linear(_pad_to(h, p2), p2, mode="fused")[:, :n_cls]


def train_sigma(p1: PTCParams, p2: PTCParams, x: torch.Tensor,
                y: torch.Tensor, steps: int, n_cls: int = T5["n_cls"],
                lr: float = T5["lr"]):
    """Σ-only full-batch AdamW on the two-layer fused PTC net; returns the
    trained (s1, s2) and each step's loss (before its update), as a
    tensor on the device."""
    s = [p1.s.clone(), p2.s.clone()]
    opt, ocfg = init_opt_state(s), AdamWConfig(lr=lr)
    losses = []
    for _ in range(steps):
        leaves = [a.detach().requires_grad_(True) for a in s]
        logits = _logits(PTCParams(p1.u, leaves[0], p1.v),
                         PTCParams(p2.u, leaves[1], p2.v), x, n_cls)
        loss = torch.mean(torch.logsumexp(logits, -1)
                          - logits.gather(-1, y[:, None].long())[:, 0])
        grads = torch.autograd.grad(loss, leaves)
        losses.append(loss.detach())
        with torch.no_grad():
            s, opt, _ = apply_updates(s, list(grads), opt, ocfg)
    return s, torch.stack(losses)


@torch.no_grad()
def t5_accuracy(p1: PTCParams, p2: PTCParams, s, x_test, y_test,
                n_cls: int = T5["n_cls"]) -> float:
    logits = _logits(PTCParams(p1.u, s[0], p1.v),
                     PTCParams(p2.u, s[1], p2.v), x_test, n_cls)
    return float((torch.argmax(logits, -1) == y_test).float().mean())


def table5(draws: dict, data, steps: int, device) -> list[list]:
    """Rows [k, test accuracy %, paper %, trainable Σ count]; unrounded."""
    x, y, xt, yt = (torch.as_tensor(a, device=device) for a in data)
    d = x.shape[1]
    rows = []
    for k, (p1, p2) in draws.items():
        s, _ = train_sigma(p1, p2, x, y, steps)
        acc = t5_accuracy(p1, p2, s, xt, yt)
        rows.append([k, 100 * acc, PAPER_T5.get(k, ""), d * d // k])
    return rows


def main(budget: str = "normal", device=None, t4_ks=None) -> dict:
    """Emit Tables 3, 4 and 5 on ``device`` (default ``cuda``); returns
    {table: rows} as the reference rounds them.  ``t4_ks`` runs Table 4 at
    those of the budget's block sizes only (every draw is made as for all
    of them, so each row it keeps is the full table's)."""
    dev = resolve_device(device)
    ks = block_sizes(budget)
    gen = cpu_generator(0)
    t3 = table3(t3_weight().to(dev), to_device(draw_t3(gen, ks), dev), dev)
    cfgs = {k: t4_config(k, budget) for k in ks}
    t4_draws = draw_t4(gen, cfgs)
    if t4_ks is not None:
        t4_draws = {k: t4_draws[k] for k in t4_ks}
    t4 = table4(to_device(t4_draws, dev), cfgs, dev)
    steps = T5["quick_steps"] if budget == "quick" else T5["steps"]
    t5 = table5(to_device(draw_t5(gen, ks), dev), t5_data(), steps, dev)
    tables = {
        "table3_noise_error_vs_k": [[k, round(e, 4), p] for k, e, p in t3],
        "table4_ic_mse_vs_k": [[k, round(e, 4), p] for k, e, p in t4],
        "table5_subspace_acc_vs_k": [[k, round(a, 2), p, n]
                                     for k, a, p, n in t5]}
    emit("table3_noise_error_vs_k", ["k", "rel_err", "paper"],
         tables["table3_noise_error_vs_k"])
    emit("table4_ic_mse_vs_k", ["k", "ic_mse", "paper"],
         tables["table4_ic_mse_vs_k"])
    emit("table5_subspace_acc_vs_k",
         ["k", "acc_%", "paper_%(vgg8)", "trainable_sigma"],
         tables["table5_subspace_acc_vs_k"])
    return tables


if __name__ == "__main__":
    main()
