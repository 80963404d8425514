"""gemma2-27b: 46L d=4608 32H(kv=16) d_ff=36864 vocab 256000 — alternating
local(4096-window)/global attention, attn+final logit soft-caps, sandwich
norms, GeGLU.  [arXiv:2408.00118]"""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab=256000,
    local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    act="gelu", tie_embed=True,
    attn_chunk=2048,
)
