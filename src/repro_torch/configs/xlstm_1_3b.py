"""xlstm-1.3b — mLSTM (matrix memory, chunkwise-parallel) + sLSTM blocks
[arXiv:2405.04517]. d_ff=0: projection factor lives inside the blocks.
48 blocks = 6 super-blocks of (7 mLSTM + 1 sLSTM)."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8, mlstm_proj_factor=2.0, ssm_chunk=128,
).validate()


def smoke():
    return reduced(CONFIG, d_ff=0, slstm_every=2, n_heads=2, n_kv_heads=2)
