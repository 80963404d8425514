"""Mamba-1 selective SSM (falcon-mamba; jamba's mamba layers).

Counterpart of ``repro/models/ssm.py``.  The in/x/dt/out projections are
PTC linears; the selective recurrence is elementwise and diagonal (no
dense matrix, so no PTC), and its small parameters (A, D, the conv taps,
the dt bias) stay fp32.

The reference has no kernel here: it scans in plain ``jnp``
(``lax.associative_scan`` inside fixed-size chunks, the state carried
across chunks).  The port keeps the chunking, so at most one chunk's
(B, c, d_inner, N) discretized terms are ever held, and runs the
recurrence token by token inside each chunk, which is exact.  Decode is
the single-step recurrence against a carried ``{"h", "conv"}`` state;
the conv state is bf16 for every model dtype, as the reference keeps it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import PTCLinearCfg, apply_ptc_linear, init_ptc_linear

__all__ = ["SSMCfg", "init_mamba", "mamba", "mamba_decode", "init_ssm_state"]

Params = dict


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_state: int = 16
    expand: int = 2
    conv_width: int = 4
    dt_rank: int | None = None      # default d_model/16
    chunk: int = 256                # scan chunk length

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank if self.dt_rank is not None else max(
            1, self.d_model // 16)


def init_mamba(gen: torch.Generator, cfg: SSMCfg, lin: PTCLinearCfg
               ) -> Params:
    """One mamba layer's parameters on the generator's device."""
    din, n, r = cfg.d_inner, cfg.d_state, cfg.rank
    dev = gen.device
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev).repeat(din, 1)
    return {
        "in_proj": init_ptc_linear(gen, cfg.d_model, 2 * din, lin),
        "conv_w": 0.1 * torch.randn((cfg.conv_width, din), generator=gen,
                                    device=dev),
        "conv_b": torch.zeros((din,), dtype=torch.float32, device=dev),
        "x_proj": init_ptc_linear(gen, din, r + 2 * n, lin),
        "dt_proj": init_ptc_linear(gen, r, din, lin, bias=True),
        "a_log": torch.log(a),          # A = −exp(a_log) (stability)
        "d": torch.ones((din,), dtype=torch.float32, device=dev),
        "out_proj": init_ptc_linear(gen, din, cfg.d_model, lin),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           init_state: torch.Tensor | None = None):
    """x: (B, S, D); w: (W, D) depthwise taps → (silu'd causal conv, the
    last W-1 inputs in x's dtype).  A bf16 ``x`` times the fp32 taps gives
    an fp32 result.  ``init_state``: (B, W-1, D) carry-in (decode)."""
    width = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(width))
    return F.silu(out + b), xp[:, -(width - 1):]


def _ssm_params(p: Params, cfg: SSMCfg, lin: PTCLinearCfg, xc: torch.Tensor):
    """Input-dependent Δ, B, C (fp32) from the conv'd activations xc."""
    n, r = cfg.d_state, cfg.rank
    proj = apply_ptc_linear(p["x_proj"], xc, lin, d_out=r + 2 * n,
                            name="x_proj")
    dt, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    dt = apply_ptc_linear(p["dt_proj"], dt, lin, d_out=cfg.d_inner,
                          name="dt_proj")
    dt = F.softplus(dt.float())
    return dt, b_ssm.float(), c_ssm.float()


def _scan(xc, dt, b_ssm, c_ssm, a, chunk: int, h: torch.Tensor):
    """h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t B_t, y_t = h_t · C_t over the S
    tokens, ``chunk`` at a time: (y (B, S, din) fp32, the last h)."""
    ys = []
    for c0 in range(0, xc.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        abar = torch.exp(dt[:, sl, :, None] * a)                # (B,c,din,N)
        bx = (dt[:, sl] * xc[:, sl].float())[..., None] \
            * b_ssm[:, sl, None, :]
        hs = torch.empty_like(abar)
        for t in range(abar.shape[1]):
            h = abar[:, t] * h + bx[:, t]
            hs[:, t] = h
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, c_ssm[:, sl]))
    return torch.cat(ys, dim=1), h


def _gate_out(p: Params, cfg: SSMCfg, lin: PTCLinearCfg, y, xc, z, dtype):
    y = y + p["d"] * xc.float()
    y = (y * F.silu(z.float())).to(dtype)
    return apply_ptc_linear(p["out_proj"], y, lin, d_out=cfg.d_model,
                            name="out_proj")


def mamba(p: Params, cfg: SSMCfg, lin: PTCLinearCfg, x: torch.Tensor,
          return_state: bool = False):
    """Prefill / training path: the chunked selective scan over x (B, S,
    d).  With ``return_state`` also the state after the last token, as
    :func:`mamba_decode` carries it."""
    din = cfg.d_inner
    xz = apply_ptc_linear(p["in_proj"], x, lin, d_out=2 * din,
                          name="in_proj")
    x_in, z = xz[..., :din], xz[..., din:]
    xc, conv = _causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"])
    dt, b_ssm, c_ssm = _ssm_params(p, cfg, lin, xc)
    a = -torch.exp(p["a_log"])                                  # (din, N)
    h0 = torch.zeros((x.shape[0], din, cfg.d_state), dtype=torch.float32,
                     device=x.device)
    y, h = _scan(xc, dt, b_ssm, c_ssm, a, min(cfg.chunk, x.shape[1]), h0)
    out = _gate_out(p, cfg, lin, y, xc, z, x.dtype)
    if return_state:
        return out, {"h": h, "conv": conv.to(torch.bfloat16)}
    return out


# -- decode ------------------------------------------------------------------


def init_ssm_state(batch: int, cfg: SSMCfg, device=None) -> Params:
    return {"h": torch.zeros((batch, cfg.d_inner, cfg.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                                dtype=torch.bfloat16, device=device)}


def mamba_decode(p: Params, cfg: SSMCfg, lin: PTCLinearCfg, x: torch.Tensor,
                 state: Params) -> tuple[torch.Tensor, Params]:
    """Single-token recurrence.  x: (B, 1, d) → (y, new_state)."""
    din = cfg.d_inner
    xz = apply_ptc_linear(p["in_proj"], x, lin, d_out=2 * din,
                          name="in_proj")
    x_in, z = xz[..., :din], xz[..., din:]
    xc, conv_new = _causal_depthwise_conv(x_in, p["conv_w"], p["conv_b"],
                                          init_state=state["conv"])
    dt, b_ssm, c_ssm = _ssm_params(p, cfg, lin, xc)
    a = -torch.exp(p["a_log"])
    abar = torch.exp(dt[:, 0, :, None] * a)                     # (B,din,N)
    bx = (dt[:, 0] * xc[:, 0].float())[..., None] * b_ssm[:, 0, None, :]
    h = abar * state["h"] + bx
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None]
    out = _gate_out(p, cfg, lin, y, xc, z, x.dtype)
    return out, {"h": h, "conv": conv_new.to(state["conv"].dtype)}
