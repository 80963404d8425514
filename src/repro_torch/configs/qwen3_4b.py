"""qwen3-4b: 36L d=2560 32H(kv=8) d_ff=9728 vocab 151936 — qk-norm, GQA.
[hf:Qwen/Qwen3-4B]

PTC padding: d_ff 9728 → 10240 (80 blocks of k=128), as the reference."""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=10240, vocab=151936,
    qk_norm=True, rope_theta=1000000.0, tie_embed=True,
    attn_chunk=2048,
)
