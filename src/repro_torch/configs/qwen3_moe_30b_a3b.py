"""qwen3-moe-30b-a3b: 48L d=2048 32H(kv=4) MoE 128e top-8, expert
d_ff=768, vocab 151936, qk-norm.  [hf:Qwen/Qwen3-30B-A3B]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936, n_experts=128, top_k=8,
    qk_norm=True, rope_theta=1000000.0, tie_embed=False,
    moe_dispatch="a2a",
    attn_chunk=2048,
)
