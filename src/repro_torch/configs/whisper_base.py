"""whisper-base: 6L enc + 6L dec, d=512 8H(kv=8) d_ff=2048 vocab 51865 —
enc-dec; the conv/audio frontend is a stub (the batch carries precomputed
frame embeddings).  [arXiv:2212.04356]

Adaptations, as the reference's: sinusoidal positions → rotary; k=64 PTC
blocks (d=512)."""
from ..models.lm import ArchConfig
from ..models.layers import PTCLinearCfg

ARCH = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865,
    norm="layernorm", act="gelu", tie_embed=True,
    ptc=PTCLinearCfg(k=64),
    attn_chunk=2048,
)
