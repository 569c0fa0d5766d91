"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer;
the vision tower is a stub (callers pass patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision, scaled per assignment]."""
import torch

from ..models import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128_256, mlp_act="swiglu",
    cross_attn_every=5, n_image_tokens=4096,
    param_dtype=torch.bfloat16,
)
