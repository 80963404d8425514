"""jamba-1.5-large-398b: 72L d=8192 64H(kv=8) — Mamba+attention 1:7
interleave (1 attn per 8-layer period), MoE 16e top-2 every other layer,
expert d_ff=24576, vocab 65536, ssm_state=16.  [arXiv:2403.19887]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    n_experts=16, top_k=2, attn_period=8, moe_period=2,
    ssm_state=16, tie_embed=False,
    moe_dispatch="a2a",
    ssm_chunk=128,
    attn_chunk=2048,
)
