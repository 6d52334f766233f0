"""tinyllama-1.1b — llama2-arch small, GQA kv=4 [arXiv:2401.02385].
Also the backbone of the end-to-end training example (examples/train_lm.py)."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, head_dim=64,
).validate()


def smoke():
    return reduced(CONFIG)
