"""llama-3.2-vision-11b: 40L d=4096 32H(kv=8) d_ff=14336 vocab 128256 —
cross-attention image layers every 5th layer; the vision tower is a stub
(the batch carries precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256,
    cross_attn_period=5, n_img_tokens=1024,
    rope_theta=500000.0, tie_embed=False,
    attn_chunk=2048,
)
