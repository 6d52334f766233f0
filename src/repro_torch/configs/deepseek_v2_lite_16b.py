"""deepseek-v2-lite-16b — MLA (kv_lora=512) + fine-grained MoE
[arXiv:2405.04434]. 64 routed experts top-6 + 2 shared, first layer dense
(d_ff=10944), expert d_ff=1408. The assignment line's "160 routed" conflicts
with its own "MoE 64e top-6"; we follow the published V2-Lite config (64e)."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, head_dim=0,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    moe=True, n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
    first_dense_layers=1,
).validate()


def smoke():
    return reduced(CONFIG)
