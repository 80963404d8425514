"""moonshot-v1-16b-a3b (Moonlight-16B-A3B): 48L d=2048 16H(kv=16) MoE 64e
top-6, expert d_ff=1408, vocab 163840.  [hf:moonshotai/Moonlight-16B-A3B]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
    rope_theta=50000.0, tie_embed=False,
    moe_dispatch="a2a",
    attn_chunk=2048,
)
