"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block every 6
layers [arXiv:2411.15242]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32_000, mlp_act="swiglu",
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    attn_every=6,
)
