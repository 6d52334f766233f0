"""phi3.5-moe-42b-a6.6b — 16 experts top-2, GQA kv=8
[hf:microsoft/Phi-3.5-MoE-instruct]. All layers MoE, no shared experts."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3.5-moe-42b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab=32064, head_dim=128,
    moe=True, n_experts=16, top_k=2, n_shared_experts=0, moe_d_ff=6400,
    first_dense_layers=0,
).validate()


def smoke():
    return reduced(CONFIG, d_ff=0)
