"""olmo-1b: 16L d=2048 16H(kv=16) d_ff=8192 vocab 50304 — non-parametric
LayerNorm, SwiGLU.  [arXiv:2402.00838]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50304,
    norm="nonparam", tie_embed=True,
    attn_chunk=2048,
)
