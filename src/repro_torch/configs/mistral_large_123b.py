"""mistral-large-123b [dense] [hf:mistralai/Mistral-Large-Instruct-2407]."""
import torch

from ..models import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32_768, mlp_act="swiglu",
    param_dtype=torch.bfloat16,
)
