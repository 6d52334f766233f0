"""internvl2-1b — InternViT frontend (STUB: input_specs supplies precomputed
patch embeddings) + qwen2-0.5b-class LM backbone [arXiv:2404.16821]."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, head_dim=64,
    n_patches=256, frontend_dim=1024, src_frontend="vit_patches",
    prefer_dp_only=True,
).validate()


def smoke():
    return reduced(CONFIG, n_heads=2, n_kv_heads=2, head_dim=32)
