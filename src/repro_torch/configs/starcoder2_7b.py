"""starcoder2-7b — dense code LM, GQA kv=4, RoPE [arXiv:2402.19173]."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128,
    mlp_gated=False,
).validate()


def smoke():
    return reduced(CONFIG)
