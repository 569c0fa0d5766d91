"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, MoE every other layer [hf:meta-llama/Llama-4 family]."""
import torch

from ..models import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048, mlp_act="swiglu",
    n_experts=128, top_k=1, moe_every=2, shared_expert_ff=8192,
    optimizer_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    microbatches=8,
)
