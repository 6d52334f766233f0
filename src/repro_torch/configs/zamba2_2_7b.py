"""zamba2-2.7b — Mamba2 backbone + weight-tied shared attention block applied
every 6 layers [arXiv:2411.15242]. d_ff applies to the shared block's MLP.
DESIGN.md notes the per-invocation LoRA on the shared block is simplified away.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, d_inner=5120, ssm_head_dim=64, ssm_chunk=128,
    attn_every=6,
).validate()


def smoke():
    return reduced(CONFIG, n_kv_heads=4)
