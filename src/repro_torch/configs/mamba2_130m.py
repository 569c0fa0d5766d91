"""mamba2-130m [ssm] — SSD (state-space duality), attn-free [arXiv:2405.21060]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=50_280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
)
