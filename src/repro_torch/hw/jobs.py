"""On-controller in-situ search jobs (device-side code).

Counterpart of ``repro/hw/jobs.py``.  A ZO loss measurement is a physical
probe, so the searches run next to the device:

* :func:`phase_refine` — the warm alternate ZCD of PM's stage 2;
* :func:`ic_search` — IC's multi-Σ_cal surrogate search (§3.2, Eq. 2).

Every block is an independent sub-problem; where the reference
``jax.vmap``s a per-block ``lax.scan``, all blocks' state here is one
(B, 2T) tensor (:func:`repro_torch.optim.zo.zo_minimize`).  One probe
rebuilds U and V of every block (mesh kernel) and streams the k unit
vectors through each block's realized ``UΣV*`` (PTC kernel) — the
measurement the reference writes as a dense block product.  The alternate
ZCD moves one of the two halves a step, so it rebuilds only that half's
unitary, and on the card replays each half's step as a CUDA graph
(:func:`_alternate_zcd`, the same bits).
"""

from __future__ import annotations

import threading

import torch

from ..core import unitary as un
from ..core.noise import NoiseModel, apply_phase_noise
from ..kernels import build
from ..kernels.ptc_block_matmul import ptc_block_matmul
from ..optim.zo import _ALT_RANGE, ZOConfig, ZOResult, step_draws, zo_minimize
from .device import DeviceRealization, realized_unitaries

__all__ = ["phase_refine", "ic_search", "probe_transfer", "job_draws"]

_CAPTURE_LOCK = threading.Lock()


def job_draws(gen: torch.Generator, method: str, b: int, steps: int,
              n_rot: int, restarts: int | None = None) -> torch.Tensor:
    """The per-step draws a job makes from ``gen``, made now: those of
    :func:`phase_refine` (alternating halves of the 2T phases), or with
    ``restarts`` those of :func:`ic_search` (one stack a restart).  A job
    given them as ``draws`` gives the bits ``gen`` gives; a transport that
    ships a job to another process or device sends these in its place."""
    n = 2 * n_rot
    if restarts is None:
        return step_draws(gen, method, b, steps, n, n_rot)
    return torch.stack([step_draws(gen, method, b, steps, n)
                        for _ in range(restarts)])


def probe_transfer(u: torch.Tensor, s: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Ŵ_b = U_b diag(s_b) V*_b, (B, k, k), measured as the k unit vectors
    through every block: the PTC forward on a (B, 1) block grid."""
    b, k, _ = u.shape
    eye = un.identity(k, u.dtype, u.device)
    y = ptc_block_matmul(eye, u[:, None], s[:, None], v[:, None])
    return y.reshape(k, b, k).permute(1, 2, 0)   # y[j, b, i] = Ŵ_b[i, j]


def _block_distance(w_hat: torch.Tensor, w: torch.Tensor,
                    den: torch.Tensor | None = None) -> torch.Tensor:
    """Normalized ‖W−W̃‖²/‖W‖² per block (as mapping.matrix_distance);
    ``den``, the targets' ‖W‖² + 1e-12, where a search made it once."""
    num = torch.sum((w_hat - w) ** 2, dim=(-2, -1))
    if den is None:
        den = torch.sum(w ** 2, dim=(-2, -1)) + 1e-12
    return num / den


def _capture(body, pool) -> tuple["torch.cuda.CUDAGraph", dict]:
    """``body`` captured as a CUDA graph (not run), and the kernel launches
    one replay makes (the wrappers' counts during the capture, taken into
    this thread's tally; each replay adds them).  The capture is
    thread-local, so a server's other sessions go on launching, allocating
    and reading back meanwhile, and one capture runs at a time."""
    graph = torch.cuda.CUDAGraph()
    # capture on a side stream, as torch.cuda.graph does, without its
    # empty_cache(): a repair captures two graphs, and hundreds of repairs
    # would each give the allocator's cache back
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with _CAPTURE_LOCK, build.tally_launches() as per_replay, \
            torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, per_replay


def _alternate_zcd(spec: un.MeshSpec, model: NoiseModel,
                   dev: DeviceRealization, phi0: torch.Tensor,  # repro: noqa[RPL103]
                   sigma: torch.Tensor, w_blocks: torch.Tensor,
                   gen: torch.Generator | None, cfg: ZOConfig,
                   draws: torch.Tensor | None) -> ZOResult:
    """:func:`zo_minimize`'s ZCD with ``alt_split`` T on
    :func:`phase_refine`'s loss, step for step and bit for bit: a step
    moves one half of ``phi`` (Φ^U on even steps, Φ^V on odd), so each
    measurement realizes that half's unitary and keeps the other's from
    the current point (one mesh build of the two, and its phase noise).

    The search state lives in fixed tensors that every step updates in
    place, with the step's draw and δ as tensors, so on the card each
    half's step is captured once as a CUDA graph (the first step of each
    half runs eagerly first) and replayed: the host enqueues one graph a
    step instead of its 56 launches."""
    if (gen is None) == (draws is None):
        raise ValueError("phase_refine: pass exactly one of gen= or draws=")
    t = spec.n_rot
    b, n = phi0.shape
    d = phi0.device
    rows = torch.arange(b, device=d)
    sides = ((slice(0, t), dev.noise_u, dev.d_u),
             (slice(t, n), dev.noise_v, dev.d_v))

    def realize(ph, side):
        cols, noise, signs = sides[side]
        return un.build_unitary(
            spec, apply_phase_noise(spec, ph[:, cols], noise, model), signs)

    den = torch.sum(w_blocks ** 2, dim=(-2, -1)) + 1e-12

    def loss(uv):
        return _block_distance(probe_transfer(uv[0], sigma, uv[1]), w_blocks,
                               den)

    uv = [realize(phi0, 0), realize(phi0, 1)]
    f = loss(uv)
    st = dict(x=phi0.clone(), f=f, best_x=phi0.clone(), best_f=f.clone())
    raw = torch.zeros((b,), dtype=torch.int64, device=d)
    delta = float(cfg.delta0)
    delta_t = torch.full((), delta, dtype=phi0.dtype, device=d)

    def body(side):
        lo, hi = (0, t) if side == 0 else (t, n)
        x = st["x"]
        i = lo + raw % (hi - lo)
        xp = x.clone()
        xp[rows, i] += delta_t
        up = list(uv)
        up[side] = realize(xp, side)
        f_plus = loss(up)
        better = f_plus < st["f"]
        x_new = x.clone()
        x_new[rows, i] += torch.where(better, delta_t, -delta_t)
        u_new = realize(x_new, side)
        f_new = torch.where(better, f_plus,
                            loss([u_new, uv[1]] if side == 0 else
                                 [uv[0], u_new]))
        better = f_new < st["best_f"]
        st["best_f"].copy_(torch.where(better, f_new, st["best_f"]))
        st["best_x"].copy_(torch.where(better[:, None], x_new, st["best_x"]))
        st["x"].copy_(x_new)
        st["f"].copy_(f_new)
        uv[side].copy_(u_new)

    graphs, pool = {}, None
    history = []
    for step in range(cfg.steps):
        side = step % 2
        raw.copy_(draws[:, step] if draws is not None else
                  torch.randint(0, _ALT_RANGE, (b,), generator=gen,
                                device=gen.device))
        if d.type != "cuda" or step < 2:
            body(side)
        else:
            if side not in graphs:
                graphs[side] = _capture(lambda: body(side), pool)
                pool = graphs[side][0].pool()
            graph, per_replay = graphs[side]
            graph.replay()
            build.add_launches(per_replay)
        if (step + 1) % cfg.inner == 0:
            delta = max(delta / cfg.decay, cfg.delta_min)
            delta_t.fill_(delta)
        if (step + 1) % cfg.record_every == 0:
            history.append(st["best_f"].clone())
    hist = torch.stack(history, dim=-1) if history else phi0.new_zeros((b, 0))
    return ZOResult(x=st["best_x"], f=st["best_f"], history=hist)


def phase_refine(spec: un.MeshSpec, model: NoiseModel,
                 dev: DeviceRealization, phi0: torch.Tensor,  # repro: noqa[RPL103]
                 sigma: torch.Tensor, w_blocks: torch.Tensor,
                 gen: torch.Generator | None, cfg: ZOConfig,
                 method: str = "zcd",
                 draws: torch.Tensor | None = None) -> ZOResult:
    """Alternate ZCD on ``phi = [Φ^U | Φ^V]`` (B, 2T) against per-block
    targets, warm-started from ``phi0`` (ZTP and ZGD move both halves at
    once and go through :func:`zo_minimize`)."""
    t = spec.n_rot
    sigma = sigma.contiguous()
    if method == "zcd":
        return _alternate_zcd(spec, model, dev, phi0, sigma, w_blocks, gen,
                              cfg, draws)

    def loss(ph):
        u, v = realized_unitaries(spec, ph[:, :t], ph[:, t:], dev, model)  # repro: noqa[RPL103]
        return _block_distance(probe_transfer(u, sigma, v), w_blocks)

    return zo_minimize(loss, phi0, cfg, method, alt_split=t, gen=gen,
                       draws=draws)


def ic_search(spec: un.MeshSpec, model: NoiseModel, dev: DeviceRealization,  # repro: noqa[RPL103]
              gen: torch.Generator | None, cfg: ZOConfig,
              sigs: torch.Tensor, method: str = "zcd", restarts: int = 4,
              draws: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Identity Calibration's surrogate search (Eq. 2).

    One loss measurement probes every block with the k unit vectors per
    Σ_cal setting (``sigs``, (n_sigma, k)) and compares the intensities of
    ``U Σ V* Σ⁻¹`` with I.  ``restarts`` cyclic restarts halve δ₀ each
    cycle.  ``draws``, if given, holds each restart's per-step draws
    (restarts, B, steps[, n]).  Returns ``(phi, final_loss, history)``.
    """
    t = spec.n_rot
    n_blocks = dev.d_u.shape[0]
    k = spec.k
    eye = torch.eye(k, dtype=torch.float32, device=sigs.device)
    sig_rows = [sig.expand(n_blocks, k).contiguous() for sig in sigs]

    def loss(phi):
        u, v = realized_unitaries(spec, phi[:, :t], phi[:, t:], dev, model)  # repro: noqa[RPL103]
        total = 0.0
        for sig, sig_b in zip(sigs, sig_rows):
            m = probe_transfer(u, sig_b, v) / sig   # U Σ V* Σ⁻¹, Σ⁻¹ electronic
            total = total + torch.mean((torch.abs(m) - eye) ** 2, dim=(-2, -1))
        return total / len(sig_rows)

    x = torch.zeros((n_blocks, 2 * t), dtype=torch.float32,
                    device=sigs.device)
    histories = []
    res = None
    for r in range(restarts):
        cfg_r = cfg._replace(delta0=cfg.delta0 / (2.0 ** r))
        res = zo_minimize(loss, x, cfg_r, method, gen=gen,
                          draws=None if draws is None else draws[r])
        x = res.x
        histories.append(res.history)
    return x, res.f, torch.cat(histories, dim=-1)
