"""chatglm3-6b: 28L d=4096 32H(kv=2) d_ff=13696 vocab 65024 — 2d-RoPE
(half-dim rotary), qkv bias, GQA kv=2.  [arXiv:2406.12793]

PTC padding: d_ff 13696 → 14336 (112 blocks of k=128), as the reference."""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=14336, vocab=65024,
    rope_frac=0.5, qkv_bias=True, tie_embed=False,
    attn_chunk=2048,
)
