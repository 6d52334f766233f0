"""granite-20b — dense code LM, llama-style, MQA (kv=1) [arXiv:2405.04324]."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    mlp_gated=False,
).validate()


def smoke():
    return reduced(CONFIG, n_kv_heads=1)
