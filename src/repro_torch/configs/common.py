"""Smoke reductions (counterpart of ``repro/configs/common.py``)."""

from __future__ import annotations

import dataclasses

import torch

from ..models.layers import PTCLinearCfg
from ..models.lm import ArchConfig, period_plan

__all__ = ["smoke_reduce"]


def smoke_reduce(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small widths, two periods, at most 4
    experts (top-2) and 8 SSM states, 2 encoder layers, 8 image tokens,
    tiny vocab, no attention chunking and no recomputation, k = 8 fp32
    PTC — runs a real step on a CPU in well under a second."""
    plan, _ = period_plan(cfg)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(plan) * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        head_dim=16,
        d_ff=96,
        vocab=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_img_tokens=8 if cfg.n_img_tokens else 0,
        sliding_window=8 if cfg.sliding_window else None,
        attn_chunk=None,
        remat=False,
        ptc=PTCLinearCfg(k=8, mode=cfg.ptc.mode, base_dtype=torch.float32),
    )
