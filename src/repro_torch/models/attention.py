"""GQA self/cross attention over PTC-factorized projections.

Counterpart of ``repro/models/attention.py``: grouped KV heads, qk-norm
(qwen3), logit soft-capping (gemma2), sliding-window local layers
(gemma2), partial rotary (chatglm) and cross-attention (whisper's
decoder, llama-vision), on three paths:

* training and prefill (``attention``): materialized-scores attention
  (``_sdpa``), or above ``chunk`` keys the online softmax over KV chunks
  (``_sdpa_chunked``, each chunk recomputed in the backward, as the
  reference's ``jax.checkpoint`` per chunk does), all in plain PyTorch as
  the reference computes them in plain ``jnp``;
* the solo serve path: one token against a dense (B, S, Hkv, Dh) KV
  cache with one shared length;
* the continuous-batching gateway: page-assembled KV views with per-slot
  cache lengths.

GQA expands KV head h // rep to query head h (``repeat_interleave``,
``jnp.repeat``'s semantics).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.prefill_attn import prefill_attention
from .layers import (PTCLinearCfg, apply_ptc_linear, apply_rotary,
                     init_ptc_linear, init_rmsnorm, rmsnorm, rotary_cache,
                     softcap)

__all__ = ["AttnCfg", "init_attention", "attention", "init_kv_cache",
           "decode_attention", "decode_attention_paged",
           "decode_attention_paged_chunked"]

Params = dict
NEG_INF = -2.0 ** 30


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_frac: float = 1.0          # <1 = partial rotary (chatglm 2d-RoPE)
    qk_norm: bool = False           # qwen3
    attn_softcap: float | None = None   # gemma2
    qkv_bias: bool = False          # chatglm3
    causal: bool = True             # False for encoder / cross-attn
    window: int | None = None       # sliding window (gemma2 local layers)


def init_attention(gen: torch.Generator, cfg: AttnCfg,
                   lin: PTCLinearCfg) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    p: Params = {
        "wq": init_ptc_linear(gen, d, cfg.n_heads * hd, lin, bias=cfg.qkv_bias),
        "wk": init_ptc_linear(gen, d, cfg.n_kv_heads * hd, lin,
                              bias=cfg.qkv_bias),
        "wv": init_ptc_linear(gen, d, cfg.n_kv_heads * hd, lin,
                              bias=cfg.qkv_bias),
        "wo": init_ptc_linear(gen, cfg.n_heads * hd, d, lin),
    }
    if cfg.qk_norm:
        p["qn"] = init_rmsnorm(hd, gen.device)
        p["kn"] = init_rmsnorm(hd, gen.device)
    return p


def _project_qkv(p: Params, cfg: AttnCfg, lin: PTCLinearCfg, x, positions,
                 kv_x=None):
    """Project q from x (B, S, d) and k, v from ``kv_x`` (B, S_kv, d;
    default x); qk-norm, then rotary at ``positions`` (B, S) — none when
    ``positions`` is None, as for cross-attention."""
    b, sq = x.shape[0], x.shape[1]
    kv_x = x if kv_x is None else kv_x
    q = apply_ptc_linear(p["wq"], x, lin, d_out=cfg.n_heads * cfg.head_dim,
                         name="wq")
    k = apply_ptc_linear(p["wk"], kv_x, lin,
                         d_out=cfg.n_kv_heads * cfg.head_dim, name="wk")
    v = apply_ptc_linear(p["wv"], kv_x, lin,
                         d_out=cfg.n_kv_heads * cfg.head_dim, name="wv")
    q = q.reshape(b, sq, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, kv_x.shape[1], cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, kv_x.shape[1], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    if cfg.rope_frac > 0 and positions is not None:
        cos, sin = rotary_cache(positions, cfg.head_dim, cfg.rope_theta,
                                cfg.rope_frac)
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
    return q, k, v


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with JAX's type promotion (fp32 × bf16 → fp32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _attend_one(p: Params, cfg: AttnCfg, lin: PTCLinearCfg, q, k, v,
                lens) -> torch.Tensor:
    """One query token per row against (B, S, Hkv, Dh) keys and values
    whose valid entries end at ``lens`` (an int or (B, 1, 1, 1)): scaled,
    soft-capped, windowed softmax attention in fp32 logits, then the
    output projection."""
    b, sk = q.shape[0], k.shape[1]
    rep = cfg.n_heads // cfg.n_kv_heads
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    logits = _einsum("bqhd,bkhd->bhqk", q, kr).float()
    logits = logits * (cfg.head_dim ** -0.5)
    logits = softcap(logits, cfg.attn_softcap)
    ki = torch.arange(sk, device=q.device)[None, None, None, :]
    ok = ki <= lens
    if cfg.window is not None:
        ok = ok & (ki > lens - cfg.window)
    logits = torch.where(ok, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = _einsum("bhqk,bkhd->bqhd", w, vr)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
    return apply_ptc_linear(p["wo"], o, lin, d_out=cfg.d_model, name="wo")


# -- training / prefill ------------------------------------------------------


def _mask_bias(sq: int, sk: int, causal: bool, window: int | None,
               q_offset: int = 0, dtype=torch.float32, device=None):
    """(sq, sk) additive mask: 0 where query i (at ``i + q_offset``) may
    see key j, ``NEG_INF`` elsewhere."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    return torch.where(ok, 0.0, NEG_INF).to(dtype)


def _sdpa(q, k, v, cfg: AttnCfg, q_offset: int = 0):
    """Materialized-scores attention: q (B, Sq, H, Dh), k/v (B, Sk, Hkv,
    Dh); the scores in fp32, the weights cast back to q's dtype."""
    sq, hd = q.shape[1], q.shape[3]
    rep = q.shape[2] // k.shape[2]
    kr = k.repeat_interleave(rep, dim=2)
    vr = v.repeat_interleave(rep, dim=2)
    logits = _einsum("bqhd,bkhd->bhqk", q, kr).float() * hd ** -0.5
    logits = softcap(logits, cfg.attn_softcap)
    logits = logits + _mask_bias(sq, k.shape[1], cfg.causal, cfg.window,
                                 q_offset, device=q.device)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum("bhqk,bkhd->bqhd", w, vr)


def _sdpa_chunked(q, k, v, cfg: AttnCfg, chunk: int):
    """Online-softmax attention over KV chunks of ``chunk`` keys: O(S ·
    chunk) memory, the same function as :func:`_sdpa`.  Each chunk's step
    runs under ``torch.utils.checkpoint``, so the backward recomputes its
    (B, H, S, chunk) scores instead of keeping them."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if sk % chunk:
        raise ValueError(f"_sdpa_chunked: {sk} keys are not a multiple of "
                         f"the chunk {chunk}")
    rep = h // k.shape[2]
    qi = torch.arange(sq, device=q.device)[:, None]

    def body(acc, m, denom, kb, vb, c0):
        kb = kb.repeat_interleave(rep, dim=2)
        vb = vb.repeat_interleave(rep, dim=2)
        logits = _einsum("bqhd,bkhd->bhqk", q, kb).float() * hd ** -0.5
        logits = softcap(logits, cfg.attn_softcap)
        ki = c0 + torch.arange(chunk, device=q.device)[None, :]
        ok = torch.ones((sq, chunk), dtype=torch.bool, device=q.device)
        if cfg.causal:
            ok = ok & (ki <= qi)
        if cfg.window is not None:
            ok = ok & (ki > qi - cfg.window)
        logits = logits + torch.where(ok, 0.0, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        denom = denom * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + _einsum(
            "bhqk,bkhd->bhqd", pexp.to(q.dtype), vb).float()
        return acc, m_new, denom

    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        acc, m, denom = checkpoint(
            body, acc, m, denom, k[:, c0:c0 + chunk], v[:, c0:c0 + chunk],
            c0, use_reentrant=False, preserve_rng_state=False)
    out = acc / denom[..., None]
    return out.transpose(1, 2).to(q.dtype)


def attention(p: Params, cfg: AttnCfg, lin: PTCLinearCfg, x, positions,
              kv_x=None, chunk: int | None = None):
    """The full attention layer (training / prefill): project, attend,
    output projection.  ``kv_x`` makes it cross-attention; above ``chunk``
    keys the attention runs chunked."""
    q, k, v = _project_qkv(p, cfg, lin, x, positions, kv_x)
    if chunk is not None and k.shape[1] > chunk:
        o = _sdpa_chunked(q, k, v, cfg, chunk)
    else:
        o = _sdpa(q, k, v, cfg)
    o = o.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    return apply_ptc_linear(p["wo"], o, lin, d_out=cfg.d_model, name="wo")


# -- decode (serve path) ------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, cfg: AttnCfg,
                  dtype=torch.bfloat16, device=None) -> Params:
    """A zeroed dense KV cache, ``{"k", "v"}`` of (B, S, Hkv, Dh), in bf16
    whatever the model's dtype, as the reference keeps it."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Params, cfg: AttnCfg, lin: PTCLinearCfg, x, cache,
                     cache_len: int):
    """One-token decode against a populated dense KV cache (plain PyTorch:
    no TPU kernel computes it).

    x: (B, 1, d); cache k/v: (B, S, Hkv, Dh); cache_len: the number of
    valid cache entries, shared by the batch.  The new K/V row is written
    into ``cache`` in place at ``cache_len`` (clamped to the cache, as
    ``dynamic_update_slice`` clamps its start); returns ``(out, cache)``.
    """
    b = x.shape[0]
    cache_len = int(cache_len)
    positions = torch.full((b, 1), cache_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, lin, x, positions)
    at = min(max(cache_len, 0), cache["k"].shape[1] - 1)
    cache["k"][:, at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, at] = v_new[:, 0].to(cache["v"].dtype)
    return _attend_one(p, cfg, lin, q, cache["k"], cache["v"],
                       cache_len), cache


def decode_attention_paged(p: Params, cfg: AttnCfg, lin: PTCLinearCfg, x,
                           k_view, v_view, lens):
    """One-token decode against page-assembled per-slot KV views with
    per-slot cache lengths (the gateway's ``prefill_chunk`` = 1 path,
    plain PyTorch: no TPU kernel computes it).

    x: (B, 1, d); k_view/v_view: (B, S_max, Hkv, Dh); lens: (B,) int32.
    Returns ``(out, k_new, v_new)``: the caller persists the new
    (B, 1, Hkv, Dh) rows into the page pool; the views are step-scratch.
    """
    b = x.shape[0]
    lens = lens.to(torch.int32)
    q, k_new, v_new = _project_qkv(p, cfg, lin, x, lens[:, None])
    sk = k_view.shape[1]
    # splice each slot's new row in at its own write position (clamped to
    # the view, as dynamic_update_slice clamps its start)
    at = lens.long().clamp(0, sk - 1)
    rows = torch.arange(b, device=x.device)
    k = k_view.clone()
    v = v_view.clone()
    k[rows, at] = k_new[:, 0].to(k.dtype)
    v[rows, at] = v_new[:, 0].to(v.dtype)
    out = _attend_one(p, cfg, lin, q, k, v, lens[:, None, None, None])
    return out, k_new, v_new


def decode_attention_paged_chunked(p: Params, cfg: AttnCfg,
                                   lin: PTCLinearCfg, x, k_view, v_view,
                                   lens, kv_block: int | None = None):
    """C-token chunked prefill against page-assembled per-slot views.

    x: (B, C, d) — each slot's next C tokens (padding columns are
    arbitrary: the causal mask and the caller's length bookkeeping keep
    them out of every surviving value); lens: (B,) int32, so chunk column
    c sits at absolute position ``lens[b] + c``.  Attention runs through
    the ``prefill_attention`` kernel over the view with the chunk's own
    K/V rows spliced in, ``kv_block`` keys to a block.

    The splice selects by absolute position — view row ``lens[b] + c``
    takes chunk column c, every other row keeps the pool's value — and is
    never a slice assignment, which would clamp or raise for a chunk
    reaching past S_max.

    Returns ``(out, k_new, v_new)`` with out (B, C, d) and k_new / v_new
    (B, C, Hkv, Dh) for the caller's multi-row page scatter.
    """
    b, c = x.shape[0], x.shape[1]
    lens = lens.to(torch.int32)
    positions = lens[:, None] + torch.arange(c, dtype=torch.int32,
                                             device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(p, cfg, lin, x, positions)
    s = k_view.shape[1]
    rel = torch.arange(s, dtype=torch.int32, device=x.device)[None, :] \
        - lens[:, None]                                            # (B, S)
    in_chunk = ((rel >= 0) & (rel < c))[:, :, None, None]
    sel = rel.clamp(0, c - 1).long()
    rows = torch.arange(b, device=x.device)[:, None]

    def splice(view, new):
        return torch.where(in_chunk, new.to(view.dtype)[rows, sel], view)

    o = prefill_attention(lens, q.contiguous(), splice(k_view, k_new),
                          splice(v_view, v_new), blk=kv_block,
                          window=cfg.window, cap=cfg.attn_softcap)
    o = o.reshape(b, c, cfg.n_heads * cfg.head_dim)
    out = apply_ptc_linear(p["wo"], o, lin, d_out=cfg.d_model, name="wo")
    return out, k_new, v_new
