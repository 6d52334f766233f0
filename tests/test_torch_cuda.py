"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (sm_90a): every test is marked `cuda` and
skips elsewhere.  Run on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports torch and numpy only (the machine with the card has no
jax); the plain versions are themselves held against the JAX package in
tests/test_torch_kernels.py.  Tolerances are those of
tests/test_kernels.py::tol: 2e-5 in f32, 2e-2 in bf16 (one bf16 ulp near
1 is 7.8e-3; the kernels sum in another order than the plain versions).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rms

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def arr(rng, *shape, dtype):
    return torch.tensor(rng.standard_normal(shape), dtype=dtype,
                        device="cuda")


def close(got, want, dtype):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=tol(dtype), rtol=tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 2048), (1, 40)])
def test_rmsnorm_kernel(dtype, shape):
    rng = np.random.default_rng(0)
    x = arr(rng, *shape, dtype=dtype)
    w = arr(rng, shape[-1], dtype=dtype)
    before = rms.rmsnorm.launches
    close(rms.rmsnorm(x, w, eps=1e-5), ref.rmsnorm(x, w, eps=1e-5), dtype)
    assert rms.rmsnorm.launches == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (4, 32, 4, 2048, 64),      # the serving shape (GQA, G = 8)
    (3, 8, 1, 1000, 32),       # MQA, S no tile divides
    (2, 4, 4, 130, 128),       # MHA, wide head
])
def test_decode_attention_kernel(dtype, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(1)
    q = arr(rng, B, Hq, D, dtype=dtype)
    k, v = arr(rng, B, Hkv, S, D, dtype=dtype), arr(rng, B, Hkv, S, D,
                                                   dtype=dtype)
    lens = [0, 1, S - 37, S][:B] if B > 3 else [0, S - 37, S][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o, (m, l) = dec.decode_attention(q, k, v, kv_len=kv_len,
                                     return_residuals=True)
    o_r, (m_r, l_r) = ref.decode_attention(q, k, v, kv_len=kv_len,
                                           return_residuals=True)
    close(o, o_r, dtype)
    assert torch.all(o[kv_len == 0] == 0)
    close(m, m_r, torch.float32 if dtype == torch.float32 else dtype)
    np.testing.assert_allclose(l.cpu().numpy(), l_r.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D", [
    (3, 32, 4, 512, 2048, 64),   # the serving prefill chunk
    (2, 32, 4, 8, 2048, 64),     # a short continuation chunk
    (2, 6, 2, 67, 300, 32),      # ragged T and S
    (1, 2, 2, 5, 77, 128),
])
def test_chunk_attention_kernel(dtype, B, Hq, Hkv, T, S, D):
    rng = np.random.default_rng(2)
    q = arr(rng, B, Hq, T, D, dtype=dtype)
    k, v = arr(rng, B, Hkv, S, D, dtype=dtype), arr(rng, B, Hkv, S, D,
                                                   dtype=dtype)
    pos = torch.tensor(rng.integers(0, S - T + 1, B), dtype=torch.int32,
                       device="cuda")
    pos[0] = 0
    before = dec.chunk_attention.launches
    close(dec.chunk_attention(q, k, v, pos=pos),
          ref.chunk_attention(q, k, v, pos=pos), dtype)
    assert dec.chunk_attention.launches == before + 1


def test_engine_on_the_card_matches_the_plain_path():
    """A small f32 model served on the card through the kernels gives the
    same greedy tokens as the plain versions on the card, and every
    kernel of the path was launched."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_smoke("tinyllama_1_1b"), n_layers=2,
                              vocab=256)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (3, 17, 40, 9)]
    outs = {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device="cuda")
        engine = ServingEngine(model, model.init(0), ServeConfig(
            max_batch=3, max_seq_len=96, prefill_chunk=16, eos_token=-1,
            min_chunk_bucket=4))
        ops.reset_launch_counts()
        reqs = [engine.submit(p, 6) for p in prompts]
        engine.run_until_drained()
        outs[impl] = [r.output for r in reqs]
        counts = ops.launch_counts()
        if impl == "kernel":
            assert all(n > 0 for n in counts.values()), counts
        else:
            assert not any(counts.values()), counts
    assert outs["kernel"] == outs["ref"]
