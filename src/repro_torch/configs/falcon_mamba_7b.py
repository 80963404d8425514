"""falcon-mamba-7b: 64L d=4096 attention-free Mamba-1, ssm_state=16,
vocab 65024.  [arXiv:2410.05355]

The selective-scan recurrence has no dense matrix, so PTC applies to the
in/x/dt/out projections, not to the recurrence itself."""
from ..models.lm import ArchConfig

ARCH = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024, ssm_state=16, tie_embed=True,
)
