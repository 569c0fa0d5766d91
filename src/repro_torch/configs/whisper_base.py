"""whisper-base [audio] — enc-dec; the conv frontend is a STUB (the
inputs are precomputed frame embeddings) [arXiv:2212.04356]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, enc_layers=6, dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51_865, mlp_act="gelu", max_seq=32_768,
)
