"""seamless-m4t-large-v2 — encoder-decoder multimodal translation backbone
[arXiv:2308.11596]. Speech frontend is a STUB (precomputed frame embeddings
via input_specs); backbone = 24L encoder + 24L decoder w/ cross-attention."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=48, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, head_dim=64,
    enc_layers=24, dec_layers=24, cross_attn=True,
    src_frontend="audio_frames", frontend_dim=1024,
    mlp_gated=False,
).validate()


def smoke():
    return reduced(CONFIG, enc_layers=2, dec_layers=2)
