"""Quickstart on the port: calibrate, map, train Σ in situ, serve requests.

    PYTHONPATH=src python -m repro_torch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

Counterpart of ``examples/quickstart.py``:

* offline dense pre-training of a d_in → d_h → d_out ReLU MLP (AdamW);
* stage 1 — Identity Calibration on a chip with one block per k×k block
  of the first weight;
* stage 2 — Parallel Mapping of both weights (commanded SVD, alternate ZO,
  OSP), each onto its own post-IC twin;
* serving — request batches answered through the chip's serve forward
  (``driver.forward_layer``, the PTC kernel) with ReLU between layers;
* stage 3 — subspace learning: AdamW on Σ only, through the blocked
  ``ptc_linear`` (forward: the PTC kernel; backward: the ``sigma_grad``
  and ``feedback_matmul`` kernels) with multi-level sampling; the trained
  Σ is then written to each chip and the request batches served again.

The defaults are the reference quickstart's 18 → 18 → 9 MLP at k = 9.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from .core.calibration import calibrate_identity, default_ic_config
from .core.mapping import parallel_map
from .core.noise import NoiseModel
from .core.ptc import PTCParams, pad_to_blocks
from .core.sparsity import SparsityConfig, smd_keep_iteration
from .core.subspace import SubspaceMasks, sample_masks
from .core import unitary as un
from .data.synthetic import synthetic_vision
from .device import resolve_device
from .kernels import build
from .models.layers import PTCLinearCfg, apply_ptc_linear
from .optim.optimizers import AdamWConfig, apply_updates, init_opt_state

__all__ = ["run", "main", "sl_grads", "subspace_learning", "SL_SPARSITY",
           "SL_OPT", "SL_STEPS"]

N_TRAIN = 1024          # training rows of the dense pre-training
PRETRAIN_STEPS = 200    # AdamW steps of the dense pre-training
# stage 3 as the reference quickstart runs it
SL_SPARSITY = SparsityConfig(alpha_w=0.6, alpha_c=0.6, alpha_d=0.2)
SL_OPT = AdamWConfig(lr=2e-3)
SL_STEPS = 150


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dense_logits(ws, x):
    return torch.relu(x @ ws[0].T) @ ws[1].T


def _accuracy(logits, y) -> float:
    return float((logits.argmax(-1) == y).float().mean())


def _ptc_logits(params: list[PTCParams], x, d_h: int, d_out: int,
                masks=(None, None)):
    """The two-layer ReLU MLP through blocked PTC linears (input zero-padded
    to the block grid, hidden and output cropped)."""
    cfg = PTCLinearCfg(k=params[0].k, mode="blocked",
                       base_dtype=torch.float32)
    layers = [dict(u=p.u, s=p.s, v=p.v) for p in params]
    h = torch.relu(apply_ptc_linear(layers[0], x, cfg, masks[0], d_out=d_h))
    return apply_ptc_linear(layers[1], h, cfg, masks[1], d_out=d_out)


def sl_grads(params: list[PTCParams], x, y, d_h: int, d_out: int,
             masks: list[SubspaceMasks | None]):
    """Loss and in-situ Σ-gradients of one SL step under the given masks;
    ``u`` and ``v`` of ``params`` stay frozen."""
    ss = [p.s.detach().requires_grad_() for p in params]
    live = [PTCParams(p.u, s, p.v) for p, s in zip(params, ss)]
    loss = F.cross_entropy(_ptc_logits(live, x, d_h, d_out, masks), y)
    return loss.detach(), list(torch.autograd.grad(loss, ss))


def subspace_learning(params: list[PTCParams], x, y, d_h: int, d_out: int,
                      gen: torch.Generator, steps: int = SL_STEPS):
    """Stage 3: AdamW on each layer's Σ with multi-level sampling — SMD
    skips an iteration, and every step that runs draws each layer's
    feedback and column masks (``SL_SPARSITY``, ``SL_OPT``).  Returns the
    trained Σ list, the number of steps run and the last loss."""
    sv = [p.s for p in params]
    opt = init_opt_state(sv)
    run_steps, loss = 0, torch.tensor(float("nan"))
    for _ in range(steps):
        if not smd_keep_iteration(gen, SL_SPARSITY):
            continue            # SMD: data-level sampling skips the step
        live = [PTCParams(p.u, s, p.v) for p, s in zip(params, sv)]
        masks = [sample_masks(gen, p, x.shape[0], SL_SPARSITY) for p in live]
        loss, grads = sl_grads(live, x, y, d_h, d_out, masks)
        sv, opt, _ = apply_updates(sv, grads, opt, SL_OPT)
        run_steps += 1
    return sv, run_steps, float(loss)


def run(d_in: int = 18, d_h: int = 18, d_out: int = 9, k: int = 9, *,
        device=None, seed: int = 0, noise: float = 0.8,
        serve_batches: int = 4, serve_rows: int = 1024,
        log=print) -> dict:
    """Run the flow end to end; return its metrics, per-stage wall times
    and kernel launch counts (each stage's own: the counts after it less
    those before it), and the deployed state: dense ``weights``, the
    ``pms`` results (their drivers hold the mapped chips, with the
    SL-trained Σ written), that Σ per layer (``sl_sigma``) and the
    ``serve`` forward.
    """
    device = resolve_device(device)
    model = NoiseModel()    # 8-bit Q, Γ, crosstalk, unknown phase bias
    stages: dict[str, dict] = {}

    def stage(name):
        _sync(device)
        before = dict(build.launch_counts)
        t0 = time.perf_counter()

        def done(**extra):
            _sync(device)
            launches = {kernel: n - before[kernel]
                        for kernel, n in build.launch_counts.items()}
            stages[name] = dict(seconds=time.perf_counter() - t0,
                                launches=launches, **extra)
            return stages[name]
        return done

    def tensors(batch):
        return (torch.as_tensor(batch["x"], device=device),
                torch.as_tensor(batch["y"], dtype=torch.long, device=device))

    x, y = tensors(synthetic_vision(seed, 0, N_TRAIN, (d_in,), d_out,
                                    noise=noise))

    # ---- offline "pre-training" (the electronics baseline) -------------
    done = stage("pretrain")
    rng = np.random.default_rng(seed)
    # the reference's 0.4 at fan-in 18, variance-matched for wider layers
    ws = [torch.as_tensor(rng.standard_normal((o, i)) * 0.4 * np.sqrt(18 / i),
                          dtype=torch.float32, device=device)
          for o, i in ((d_h, d_in), (d_out, d_h))]
    opt, ocfg = init_opt_state(ws), AdamWConfig(lr=5e-3)
    for _ in range(PRETRAIN_STEPS):
        ws = [w.requires_grad_() for w in ws]
        loss = torch.nn.functional.cross_entropy(_dense_logits(ws, x), y)
        grads = torch.autograd.grad(loss, ws)
        ws, opt, _ = apply_updates([w.detach() for w in ws], list(grads),
                                   opt, ocfg)
    dense_acc = _accuracy(_dense_logits(ws, x), y)
    done(loss=float(loss.detach()))
    log(f"[offline] dense pre-trained accuracy: {dense_acc:.3f}  "
        f"[{stages['pretrain']['seconds']:.1f}s]")

    # ---- stage 1: identity calibration ---------------------------------
    t_rot = un.mesh_spec(k, "clements").n_rot
    ic_blocks = (pad_to_blocks(d_h, k) // k) * (pad_to_blocks(d_in, k) // k)
    ic_cfg = default_ic_config(t_rot)
    done = stage("ic")
    ic = calibrate_identity(torch.Generator(device).manual_seed(seed),
                            n_blocks=ic_blocks, k=k, model=model, cfg=ic_cfg,
                            device=device)
    ic_mse = (float(ic.mse_u.mean()) + float(ic.mse_v.mean())) / 2
    done(blocks=ic_blocks, steps=ic_cfg.steps)
    log(f"[IC] identity MSE = {ic_mse:.4f} over {ic_blocks} blocks, "
        f"{ic_cfg.steps} steps x 4 restarts (paper Table 4: 0.013 @ k=9)  "
        f"[{stages['ic']['seconds']:.1f}s]")

    # ---- stage 2: parallel mapping (post-IC frame) ----------------------
    post = model.post_ic()
    done = stage("pm")
    pms = [parallel_map(torch.Generator(device).manual_seed(seed + 1 + i),
                        w, k, post, device=device) for i, w in enumerate(ws)]
    errs = {name: [float(getattr(pm, name).mean()) for pm in pms]
            for name in ("err_init", "err_zo", "err_osp")}
    done(blocks=[pm.driver.n_blocks for pm in pms],
         decompose_s=sum(pm.decompose_s for pm in pms))
    log(f"[PM] mapping error (layer 1): init={errs['err_init'][0]:.4f} "
        f"→ zo={errs['err_zo'][0]:.4f} → osp={errs['err_osp'][0]:.4f}  "
        f"[{stages['pm']['seconds']:.1f}s, of which decomposition "
        f"{stages['pm']['decompose_s']:.2f}s batched]")

    # ---- serving through the chip's serve forward ------------------------
    def serve(xb):
        h = torch.relu(pms[0].driver.forward_layer(xb))
        return pms[1].driver.forward_layer(h)

    def serve_requests():
        """Serve the request batches; (served, dense) accuracy, ms/batch."""
        correct = dense_correct = rows = 0
        batch_s = []
        for i in range(serve_batches):
            xr, yr = tensors(synthetic_vision(seed, 1 + i, serve_rows,
                                              (d_in,), d_out, noise=noise))
            _sync(device)
            t0 = time.perf_counter()
            logits = serve(xr)
            _sync(device)
            batch_s.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError("serve: non-finite logits")
            correct += int((logits.argmax(-1) == yr).sum())
            dense_correct += int((_dense_logits(ws, xr).argmax(-1)
                                  == yr).sum())
            rows += serve_rows
        return correct / rows, dense_correct / rows, batch_s

    done = stage("serve")
    mapped_acc = _accuracy(serve(x), y)
    served_acc, dense_served_acc, batch_s = serve_requests()
    done(batches=serve_batches, rows=serve_rows, batch_s=batch_s)
    log(f"[serve] mapped accuracy (training inputs): {mapped_acc:.3f}; "
        f"{serve_batches} request batches x {serve_rows} rows: served "
        f"accuracy {served_acc:.3f} (dense {dense_served_acc:.3f}), "
        f"{1e3 * float(np.mean(batch_s)):.2f} ms/batch  "
        f"[{stages['serve']['seconds']:.1f}s]")

    # ---- stage 3: subspace learning of Σ, in situ -----------------------
    params = [pm.params for pm in pms]
    done = stage("sl")
    sv, sl_steps, sl_loss = subspace_learning(
        params, x, y, d_h, d_out, torch.Generator(device).manual_seed(seed + 3))
    trained = [PTCParams(p.u, s, p.v) for p, s in zip(params, sv)]
    with torch.no_grad():
        sl_acc = _accuracy(_ptc_logits(trained, x, d_h, d_out), y)
    done(steps=sl_steps, loss=sl_loss)
    log(f"[SL] subspace-trained accuracy: {sl_acc:.3f} (dense "
        f"{dense_acc:.3f}), {sl_steps} of {SL_STEPS} steps run (SMD)  "
        f"[{stages['sl']['seconds']:.1f}s]")

    # ---- the trained Σ on the chips: serve again ------------------------
    done = stage("serve_sl")
    for pm, s in zip(pms, sv):
        pm.driver.write_sigma(s.reshape(-1, k))
    served_acc_sl, _, batch_s = serve_requests()
    done(batches=serve_batches, rows=serve_rows, batch_s=batch_s)
    log(f"[serve] after SL: served accuracy {served_acc_sl:.3f} (before SL "
        f"{served_acc:.3f}, dense {dense_served_acc:.3f})  "
        f"[{stages['serve_sl']['seconds']:.1f}s]")

    return dict(geometry=dict(d_in=d_in, d_h=d_h, d_out=d_out, k=k),
                dense_acc=dense_acc, ic_mse=ic_mse, mapped_acc=mapped_acc,
                served_acc=served_acc, dense_served_acc=dense_served_acc,
                sl_acc=sl_acc, served_acc_sl=served_acc_sl, sl_sigma=sv,
                stages=stages, weights=ws, pms=pms, serve=serve, **errs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-in", type=int, default=18)
    ap.add_argument("--d-h", type=int, default=18)
    ap.add_argument("--d-out", type=int, default=9)
    ap.add_argument("--k", type=int, default=9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(args.d_in, args.d_h, args.d_out, args.k, device=args.device,
        seed=args.seed)


if __name__ == "__main__":
    main()
