"""olmoe-1b-7b [moe] — 64 experts, top-8 routing [arXiv:2409.02060]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50_304, mlp_act="swiglu",
    n_experts=64, top_k=8, moe_every=1,
)
