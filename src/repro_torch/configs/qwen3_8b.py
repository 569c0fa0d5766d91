"""qwen3-8b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab=151_936, mlp_act="swiglu", qk_norm=True,
)
