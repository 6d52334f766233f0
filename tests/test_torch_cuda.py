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
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import mla_attention as mla
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
@pytest.mark.parametrize("shape", [(1, 2048), (8, 1, 2048), (1, 2560),
                                   (8, 1, 2560), (8, 512, 2048), (3, 5120),
                                   (2, 8192), (8, 1, 6144), (4, 512, 6144),
                                   (8, 1, 896), (4, 512, 896),
                                   (8, 40, 128), (2, 512, 8, 128)])
def test_rmsnorm_kernel_rows(dtype, shape):
    """The forward at a decode tick's rows (1 and 8 of tinyllama's 2048
    and zamba2's 2560: a block a row, one warp or two), a prefill group,
    and rows held by three, four and eight warps; granite's 6144 and
    internvl's 896 at a decode tick and a prefill group, and qwen3's
    qk-norm rows of 128; two calls agree exactly."""
    rng = np.random.default_rng(1)
    x = arr(rng, *shape, dtype=dtype)
    w = arr(rng, shape[-1], dtype=dtype)
    before = rms.rmsnorm.launches
    y = rms.rmsnorm(x, w, eps=1e-5)
    close(y, ref.rmsnorm(x, w, eps=1e-5), dtype)
    again = rms.rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert rms.rmsnorm.launches == before + 2
    assert torch.equal(y, again)
    # a row alone gives what it gives among the others
    alone = rms.rmsnorm(x.reshape(-1, shape[-1])[-1:].contiguous(), w,
                        eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(alone, y.reshape(-1, shape[-1])[-1:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (4, 32, 4, 2048, 64),      # the serving shape (GQA, G = 8)
    (3, 8, 1, 1000, 32),       # MQA, S no tile divides
    (2, 4, 4, 130, 128),       # MHA, wide head
    (4, 32, 32, 2048, 80),     # zamba2's shared block: MHA, head dim 80
    (4, 32, 8, 2048, 128),     # phi3.5-moe's decode tick: G 4, head dim 128
    (4, 48, 1, 2048, 128),     # granite's decode tick: MQA, G 48 (3 blocks)
    (4, 14, 2, 2048, 64),      # internvl's decode tick: G 7
    (4, 36, 4, 2048, 128),     # starcoder2's decode tick: G 9 (2 blocks)
    (4, 16, 16, 256, 64),      # seamless's decoder self-attention: G 1
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
    (2, 32, 32, 512, 2048, 80),  # zamba2's shared block: MHA, head dim 80
    (2, 4, 4, 67, 300, 80),
    (2, 32, 8, 512, 2048, 128),  # phi3.5-moe's prefill chunk: G 4, D 128
    (2, 32, 8, 8, 2048, 128),    # phi3.5-moe's short chunk
    (2, 48, 1, 512, 2048, 128),  # granite's prefill chunk: MQA, G 48
    (2, 48, 1, 8, 2048, 128),    # granite's short chunk
    (2, 14, 2, 512, 2048, 64),   # internvl's prefill chunk: G 7
    (2, 14, 2, 8, 2048, 64),     # internvl's short chunk
    (2, 36, 4, 512, 2048, 128),  # starcoder2's prefill chunk: G 9
    (2, 16, 16, 128, 256, 64),   # seamless's decoder prompt chunk: G 1
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


# (B, Hq, Hkv, T, S, D, pos): per-row offsets, with rows near S and rows
# whose pos + T passes S (such a row sees S columns); head dims 32, 64, 80
# and 128, G 1, 5 and 8, T 1, 8, 64 and 512.  bf16 runs the tensor-core
# kernel, f32 the FMA one.
CHUNK_CASES = [
    (2, 8, 8, 64, 300, 32, [0, 250]),          # G 1, D 32, ragged S, past S
    (1, 16, 2, 512, 600, 32, [88]),            # G 8, D 32, T 512, past S
    (2, 10, 2, 64, 333, 64, [0, 300]),         # G 5, past S
    (2, 32, 4, 1, 2048, 64, [0, 2047]),        # T 1 at the last column
    (2, 32, 4, 512, 777, 64, [0, 600]),        # T 512, G 8, ragged, past S
    (2, 32, 32, 64, 1000, 80, [0, 970]),       # zamba2: G 1, D 80, past S
    (1, 8, 8, 512, 700, 80, [100]),            # G 1, D 80, T 512
    (3, 40, 8, 8, 1000, 128, [0, 995, 500]),   # G 5, D 128, T 8, past S
    (1, 5, 1, 512, 1100, 128, [300]),          # G 5 (MQA), D 128, T 512
    (3, 4, 4, 1, 130, 128, [0, 129, 64]),      # G 1, D 128, T 1
    # short chunks deep in the cache: the split path (tests below)
    (8, 32, 4, 8, 2048, 64, [0, 5, 100, 1000, 2040, 333, 1500, 17]),
    (4, 32, 32, 8, 2048, 80, [0, 2000, 64, 1023]),
    (4, 48, 1, 8, 2048, 128, [0, 2040, 64, 1023]),   # granite: G 48
    (4, 14, 2, 8, 2048, 64, [0, 2040, 64, 1023]),    # internvl: G 7
    (4, 36, 4, 8, 2048, 128, [0, 2040, 64, 1023]),   # starcoder2: G 9
    # seamless's decoder self-attention: G 1, D 64, T 128 and T 8
    (8, 16, 16, 128, 1024, 64, [0, 128, 512, 896, 7, 300, 700, 64]),
    (4, 16, 16, 8, 1024, 64, [0, 1016, 64, 511]),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_attention_kernel_offsets(dtype, case):
    B, Hq, Hkv, T, S, D, pos_l = case
    rng = np.random.default_rng(7)
    q = arr(rng, B, Hq, T, D, dtype=dtype)
    k, v = arr(rng, B, Hkv, S, D, dtype=dtype), arr(rng, B, Hkv, S, D,
                                                   dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    before = dec.chunk_attention.launches
    close(dec.chunk_attention(q, k, v, pos=pos),
          ref.chunk_attention(q, k, v, pos=pos), dtype)
    assert dec.chunk_attention.launches == before + 1


@pytest.mark.parametrize("case", CHUNK_CASES[-2:])
def test_chunk_attention_split_path(case, monkeypatch):
    """A short chunk deep in the cache splits its columns, and the merged
    output agrees with the same kernel run unsplit (one
    range over S) and with the plain version."""
    B, Hq, Hkv, T, S, D, pos_l = case
    nsplit, _ = dec.chunk_splits(Hkv, Hq // Hkv, T, S, D)
    assert nsplit > 1
    rng = np.random.default_rng(8)
    q = arr(rng, B, Hq, T, D, dtype=torch.bfloat16)
    k = arr(rng, B, Hkv, S, D, dtype=torch.bfloat16)
    v = arr(rng, B, Hkv, S, D, dtype=torch.bfloat16)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    split = dec.chunk_attention(q, k, v, pos=pos)
    close(split, ref.chunk_attention(q, k, v, pos=pos), torch.bfloat16)
    again = dec.chunk_attention(q, k, v, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(split, again)   # the merge runs in range order
    monkeypatch.setattr(dec, "chunk_splits",
                        lambda *a: (1, -(-S // dec.TILE) * dec.TILE))
    close(split, dec.chunk_attention(q, k, v, pos=pos), torch.bfloat16)


def paged_case(rng, B, Hkv, NB, ps, D, limits, dtype):
    """A page arena holding B rows of NB pages each, through block tables
    that are a random permutation of pages 1..B*NB; table slots past each
    row's limit point at scratch page 0, which holds large finite
    garbage.  Returns (k_pages, v_pages, block_table)."""
    P = 1 + B * NB
    k = arr(rng, P, Hkv, ps, D, dtype=dtype)
    v = arr(rng, P, Hkv, ps, D, dtype=dtype)
    k[0], v[0] = 1e4, -1e4
    bt = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    for b, lim in enumerate(limits):
        bt[b, -(-lim // ps):] = 0
    return k, v, torch.tensor(bt, device="cuda")


def scrubbed(pages):
    """The same arena with scratch page 0 zeroed."""
    out = pages.clone()
    out[0] = 0
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,NB,ps,D", [
    (8, 32, 4, 32, 64, 64),    # the serving shape: one page per tile
    (4, 32, 4, 128, 16, 64),   # a tile spans four pages
    (3, 8, 1, 8, 128, 32),     # MQA, a page spans two tiles
    (2, 4, 4, 7, 48, 128),     # MHA, pages straddle tile edges
    (2, 8, 8, 5, 64, 80),      # head dim 80 (the shared template)
    (8, 32, 8, 32, 64, 128),   # phi3.5-moe's paged decode tick: G 4, D 128
    (8, 48, 1, 32, 64, 128),   # granite: MQA, G 48
    (8, 14, 2, 32, 64, 64),    # internvl: G 7
    (4, 36, 4, 128, 16, 128),  # starcoder2: G 9, four pages per tile
])
def test_decode_attention_paged_kernel(dtype, B, Hq, Hkv, NB, ps, D):
    rng = np.random.default_rng(4)
    S = NB * ps
    lens = ([S - 37, 0, 1, S] * 2)[:B]
    kp, vp, bt = paged_case(rng, B, Hkv, NB, ps, D, lens, dtype)
    q = arr(rng, B, Hq, D, dtype=dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = dec.decode_attention_paged.launches
    o = dec.decode_attention_paged(q, kp, vp, block_table=bt, kv_len=kv_len)
    close(o, ref.decode_attention_paged(q, kp, vp, block_table=bt,
                                        kv_len=kv_len), dtype)
    assert dec.decode_attention_paged.launches == before + 1
    assert torch.all(o[kv_len == 0] == 0)
    # the dense kernel on the gathered cache, and no leak from page 0
    dense = dec.decode_attention(q, ref.gather_kv_pages(kp, bt),
                                 ref.gather_kv_pages(vp, bt), kv_len=kv_len)
    close(o, dense, dtype)
    again = dec.decode_attention_paged(q, scrubbed(kp), scrubbed(vp),
                                       block_table=bt, kv_len=kv_len)
    torch.cuda.synchronize()
    assert torch.equal(o, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Hq,Hkv,T,NB,ps,D", [
    (3, 32, 4, 512, 32, 64, 64),   # the serving prefill chunk
    (2, 32, 4, 8, 128, 16, 64),    # a short chunk, four pages per tile
    (2, 6, 2, 67, 3, 128, 32),     # ragged T, a page spans two tiles
    (2, 2, 2, 5, 11, 16, 128),
    (2, 8, 8, 67, 5, 64, 80),      # head dim 80 (the shared template)
    (2, 32, 8, 512, 32, 64, 128),  # phi3.5-moe's paged prefill chunk
    (2, 32, 8, 8, 32, 64, 128),    # phi3.5-moe's paged short chunk
    (2, 48, 1, 512, 32, 64, 128),  # granite's paged prefill chunk: G 48
    (2, 48, 1, 8, 128, 16, 128),   # granite's short chunk, gathered pages
    (2, 14, 2, 512, 32, 64, 64),   # internvl's paged prefill chunk: G 7
    (2, 14, 2, 8, 128, 16, 64),    # internvl's short chunk, gathered pages
    (2, 36, 4, 512, 32, 64, 128),  # starcoder2's paged prefill chunk: G 9
])
def test_chunk_attention_paged_kernel(dtype, B, Hq, Hkv, T, NB, ps, D):
    rng = np.random.default_rng(5)
    S = NB * ps
    pos_l = [0] + list(rng.integers(0, S - T + 1, B - 1))
    kp, vp, bt = paged_case(rng, B, Hkv, NB, ps, D,
                            [p + T for p in pos_l], dtype)
    q = arr(rng, B, Hq, T, D, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    before = dec.chunk_attention_paged.launches
    o = dec.chunk_attention_paged(q, kp, vp, block_table=bt, pos=pos)
    close(o, ref.chunk_attention_paged(q, kp, vp, block_table=bt, pos=pos),
          dtype)
    assert dec.chunk_attention_paged.launches == before + 1
    again = dec.chunk_attention_paged(q, scrubbed(kp), scrubbed(vp),
                                      block_table=bt, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(o, again)
    # one arithmetic body: the dense kernel on the gathered cache gives
    # the same output (a masked entry adds exactly 0)
    dense = dec.chunk_attention(q, ref.gather_kv_pages(kp, bt),
                                ref.gather_kv_pages(vp, bt), pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(o, dense)


# (B, Hq, Hkv, T, NB, ps, D, pos) at page sizes 64 and 128 (bf16: pages
# by TMA) and 5, 8, 16 and 24 (bf16: the cp.async gather), with rows past
# NB * ps and the split path
PAGED_CHUNK_CASES = [
    (2, 32, 4, 64, 20, 24, 64, [0, 430]),          # gather route, past S
    (3, 8, 8, 8, 30, 5, 80, [0, 140, 60]),         # gather route, G 1, D 80
    (2, 32, 4, 64, 40, 8, 64, [0, 290]),           # eight pages per tile
    (2, 32, 4, 512, 48, 16, 64, [0, 300]),         # T 512, past S
    (8, 32, 4, 8, 32, 64, 64, [0, 5, 100, 1000, 2040, 333, 1500, 17]),
    (3, 32, 32, 8, 16, 128, 80, [0, 2040, 900]),   # G 1, D 80, split
    (2, 10, 2, 512, 50, 16, 128, [0, 300]),        # G 5, D 128
    (3, 8, 8, 1, 9, 8, 32, [0, 71, 30]),           # T 1, D 32
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PAGED_CHUNK_CASES)
def test_chunk_attention_paged_kernel_offsets(dtype, case):
    B, Hq, Hkv, T, NB, ps, D, pos_l = case
    rng = np.random.default_rng(9)
    kp, vp, bt = paged_case(rng, B, Hkv, NB, ps, D,
                            [p + T for p in pos_l], dtype)
    q = arr(rng, B, Hq, T, D, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    o = dec.chunk_attention_paged(q, kp, vp, block_table=bt, pos=pos)
    close(o, ref.chunk_attention_paged(q, kp, vp, block_table=bt, pos=pos),
          dtype)
    dense = dec.chunk_attention(q, ref.gather_kv_pages(kp, bt),
                                ref.gather_kv_pages(vp, bt), pos=pos)
    again = dec.chunk_attention_paged(q, scrubbed(kp), scrubbed(vp),
                                      block_table=bt, pos=pos)
    torch.cuda.synchronize()
    assert torch.equal(o, dense) and torch.equal(o, again)


# (D, G, S): decode at every compiled head dim and G 1 / 4 / 8 (and 20:
# two blocks of q heads; 48, granite's MQA: three; 7 and 9, internvl's and
# starcoder2's), S not a multiple of 64; kv_len 0, 1, S and
# the lengths on either side of the split ranges' edges
DECODE_CASES = [(D, G, S) for D, S in ((32, 1000), (64, 2000), (80, 777),
                                       (128, 600))
                for G in (1, 4, 8)] + [(64, 20, 1000), (128, 48, 1000),
                                       (64, 7, 1000), (128, 9, 1000)]


def decode_lengths(S, D=64):
    rows = dec.decode_splits(S, D)[1]
    edges = [n for r in range(1, S // rows + 1)
             for n in (r * rows - 1, r * rows, r * rows + 1)]
    return sorted({0, 1, S, S - 1, *[n for n in edges if n <= S]})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,G,S", DECODE_CASES)
def test_decode_attention_kernel_lengths(dtype, D, G, S):
    """Decode against the plain version at empty, one-row, full and
    range-edge lengths, with the (m, l) residuals."""
    rng = np.random.default_rng(11)
    lens = decode_lengths(S, D)
    B, Hkv = len(lens), 2
    q = arr(rng, B, Hkv * G, D, dtype=dtype)
    k, v = arr(rng, B, Hkv, S, D, dtype=dtype), arr(rng, B, Hkv, S, D,
                                                   dtype=dtype)
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
@pytest.mark.parametrize("S", [1024, 1000])
def test_decode_attention_cross_rows_see_the_whole_source(dtype, S):
    """seamless's cross-attention decode: 16 q over 16 kv heads of 64
    (G 1), every row at kv_len = S, the encoder's length (1000: no tile
    multiple), against the plain version with the (m, l) residuals."""
    rng = np.random.default_rng(12)
    B, H, D = 8, 16, 64
    q = arr(rng, B, H, D, dtype=dtype)
    k, v = arr(rng, B, H, S, D, dtype=dtype), arr(rng, B, H, S, D,
                                                 dtype=dtype)
    kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
    o, (m, l) = dec.decode_attention(q, k, v, kv_len=kv_len,
                                     return_residuals=True)
    o_r, (m_r, l_r) = ref.decode_attention(q, k, v, kv_len=kv_len,
                                           return_residuals=True)
    close(o, o_r, dtype)
    close(m, m_r, torch.float32 if dtype == torch.float32 else dtype)
    np.testing.assert_allclose(l.cpu().numpy(), l_r.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D,G", [(64, 8), (80, 1), (128, 4), (128, 48),
                                 (64, 7)])
def test_decode_attention_is_batch_invariant(dtype, D, G):
    """A row decoded alone gives exactly (torch.equal) what it gives
    inside a batch of 8 other rows, dense and paged: the split plan
    follows S only, never B."""
    rng = np.random.default_rng(12)
    B, Hkv, NB, ps = 9, 2, 24, 64
    S = NB * ps
    lens = [S, 1, 0, 700, 1023, 511, 513, 1300, 64]
    kp, vp, bt = paged_case(rng, B, Hkv, NB, ps, D, lens, dtype)
    k, v = ref.gather_kv_pages(kp, bt), ref.gather_kv_pages(vp, bt)
    q = arr(rng, B, Hkv * G, D, dtype=dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    batch = dec.decode_attention(q, k, v, kv_len=kv_len)
    paged = dec.decode_attention_paged(q, kp, vp, block_table=bt,
                                       kv_len=kv_len)
    for i in (0, 3, 4, 7):
        one = slice(i, i + 1)
        alone = dec.decode_attention(q[one], k[one], v[one],
                                     kv_len=kv_len[one])
        alone_p = dec.decode_attention_paged(
            q[one], kp, vp, block_table=bt[one].contiguous(),
            kv_len=kv_len[one])
        torch.cuda.synchronize()
        assert torch.equal(alone, batch[one]), i
        assert torch.equal(alone_p, paged[one]), i
    close(batch, ref.decode_attention(q, k, v, kv_len=kv_len), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [8, 512])
@pytest.mark.parametrize("D,G,Hkv", [(64, 8, 4), (80, 1, 32), (128, 4, 2),
                                     (128, 48, 1), (64, 7, 2)])
def test_chunk_attention_is_batch_invariant(dtype, T, D, G, Hkv):
    """A chunk row computed alone gives exactly (torch.equal) what it
    gives inside a batch of 8 other rows, dense and paged (page size 64,
    TMA; 16, the gather): the split plan follows (Hkv, G, T, S), never
    B."""
    rng = np.random.default_rng(13)
    B, S = 9, 2048
    pos_l = ([2040, 0, 5, 100, 1000, 333, 1500, 17, 1900] if T == 8 else
             [1536, 0, 512, 1024, 100, 700, 1300, 7, 1000])
    q = arr(rng, B, Hkv * G, T, D, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    limits = [p + T for p in pos_l]
    for ps in (64, 16):
        kp, vp, bt = paged_case(rng, B, Hkv, S // ps, ps, D, limits, dtype)
        k, v = ref.gather_kv_pages(kp, bt), ref.gather_kv_pages(vp, bt)
        batch = dec.chunk_attention(q, k, v, pos=pos)
        paged = dec.chunk_attention_paged(q, kp, vp, block_table=bt, pos=pos)
        for i in (0, 3, 4, 7):
            one = slice(i, i + 1)
            alone = dec.chunk_attention(q[one], k[one].contiguous(),
                                        v[one].contiguous(), pos=pos[one])
            alone_p = dec.chunk_attention_paged(
                q[one], kp, vp, block_table=bt[one].contiguous(),
                pos=pos[one])
            torch.cuda.synchronize()
            assert torch.equal(alone, batch[one]), (ps, i)
            assert torch.equal(alone_p, paged[one]), (ps, i)
        close(batch, ref.chunk_attention(q, k, v, pos=pos), dtype)
        del kp, vp, k, v


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [5, 16, 64])
@pytest.mark.parametrize("D,G", [(64, 8), (80, 1), (32, 4), (128, 48),
                                 (64, 7)])
def test_decode_attention_paged_equals_dense(dtype, ps, D, G):
    """The paged instance is the dense body with other row addressing
    (TMA at page size 64, the cp.async gather at 5 and 16): on the same
    K/V its output equals the dense kernel's exactly."""
    rng = np.random.default_rng(13)
    B, Hkv = 5, 2
    NB = -(-1000 // ps)
    S = NB * ps
    lens = [S, 0, 1, 999 if S > 999 else S - 1, 257]
    kp, vp, bt = paged_case(rng, B, Hkv, NB, ps, D, lens, dtype)
    q = arr(rng, B, Hkv * G, D, dtype=dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    o = dec.decode_attention_paged(q, kp, vp, block_table=bt, kv_len=kv_len)
    dense = dec.decode_attention(q, ref.gather_kv_pages(kp, bt),
                                 ref.gather_kv_pages(vp, bt), kv_len=kv_len)
    torch.cuda.synchronize()
    assert torch.equal(o, dense)
    close(o, ref.decode_attention_paged(q, kp, vp, block_table=bt,
                                        kv_len=kv_len), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_back_to_back_calls(dtype):
    """The arrival counters are reused without a memset (the merging
    block resets its own): calls with different kv_len, one after the
    other, are each right, and repeating a call repeats its output."""
    rng = np.random.default_rng(14)
    B, Hkv, G, S, D = 4, 4, 8, 2048, 64
    q = arr(rng, B, Hkv * G, D, dtype=dtype)
    k, v = arr(rng, B, Hkv, S, D, dtype=dtype), arr(rng, B, Hkv, S, D,
                                                   dtype=dtype)
    outs = []
    for lens in ([2048, 1000, 513, 0], [300, 2047, 2048, 1],
                 [2048, 1000, 513, 0]):
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        o = dec.decode_attention(q, k, v, kv_len=kv_len)
        close(o, ref.decode_attention(q, k, v, kv_len=kv_len), dtype)
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[2])


def test_paged_kernels_refuse_bad_tables():
    rng = np.random.default_rng(6)
    kp, vp, bt = paged_case(rng, 2, 2, 4, 16, 64, [64, 64], torch.float32)
    q = arr(rng, 2, 4, 64, dtype=torch.float32)
    kv_len = torch.tensor([3, 64], dtype=torch.int32, device="cuda")
    for bad in (bt.long(), bt.t().contiguous(), bt[:, ::2], bt.cpu()):
        with pytest.raises(ValueError, match="block_table"):
            dec.decode_attention_paged(q, kp, vp, block_table=bad,
                                       kv_len=kv_len)


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
            # every kernel of the contiguous path (the paged pair serves
            # the paged pool, below)
            assert all(counts[n] > 0 for n in (
                "rmsnorm", "decode_attention", "chunk_attention")), counts
        else:
            assert not any(counts.values()), counts
    assert outs["kernel"] == outs["ref"]


def test_paged_engine_on_the_card_matches_the_plain_path():
    """The paged pool on the card: the kernels and the plain versions give
    the same greedy tokens as the contiguous engine, the page gate
    back-pressures, every page comes back, and the paged kernels (not the
    dense ones) carry the attention."""
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
    for impl, pages in (("kernel", 0), ("kernel", 40), ("kernel", 9),
                        ("ref", 9)):
        model = build_model(cfg, impl=impl, device="cuda")
        engine = ServingEngine(model, model.init(0), ServeConfig(
            max_batch=3, max_seq_len=96, prefill_chunk=16, eos_token=-1,
            min_chunk_bucket=4, page_size=8, max_cache_pages=pages))
        ops.reset_launch_counts()
        reqs = [engine.submit(p, 6) for p in prompts]
        engine.run_until_drained()
        outs[impl, pages] = [r.output for r in reqs]
        counts = ops.launch_counts()
        if impl == "ref":
            assert not any(counts.values()), counts
        elif pages:
            assert counts["decode_attention_paged"] > 0 \
                and counts["chunk_attention_paged"] > 0, counts
            assert counts["decode_attention"] == 0 \
                and counts["chunk_attention"] == 0, counts
            assert engine.allocator.in_use == 0
            assert engine.allocator.hwm <= engine.allocator.usable
    assert len({str(o) for o in outs.values()}) == 1, outs


# ------------------------------------------------- MLA latent attention ----
# deepseek's served latent attention: G q heads over one latent kv head,
# K rows [ckv | krope] (512 + 64 columns), V rows ckv, read in place from
# ckv [B, S, 512] and krope [B, S, 64] (paged: two arenas through one
# block table); sm_scale (dn + dr) ** -0.5.  The plain versions are the
# reference's k/v route (tests/test_torch_mla_kernels.py).
R, DR = 512, 64
MLA_SCALE = 192 ** -0.5


def latent_cache(rng, B, S, dtype):
    return arr(rng, B, S, R, dtype=dtype), arr(rng, B, S, DR, dtype=dtype)


def latent_paged_case(rng, B, NB, ps, limits, dtype, apart=False):
    """Two page arenas, ckv [P, ps, 512] and krope [P, ps, 64], behind one
    block table that is a random permutation of pages 1..B*NB; slots past
    each row's limit point at scratch page 0, large finite garbage in
    both.  `apart`: the krope arena lies before the ckv arena in one
    allocation, so neither arena's address follows from the other's.
    Returns (ckv_pages, krope_pages, block_table)."""
    P = 1 + B * NB
    if apart:
        buf = torch.empty(P * ps * (R + DR) + 4096, dtype=dtype,
                          device="cuda")
        rp = buf[:P * ps * DR].view(P, ps, DR)
        cp = buf[4096 + P * ps * DR:].view(P, ps, R)
        cp.copy_(arr(rng, P, ps, R, dtype=dtype))
        rp.copy_(arr(rng, P, ps, DR, dtype=dtype))
    else:
        cp, rp = arr(rng, P, ps, R, dtype=dtype), arr(rng, P, ps, DR,
                                                     dtype=dtype)
    cp[0], rp[0] = 1e4, -1e4
    bt = rng.permutation(np.arange(1, P)).reshape(B, NB).astype(np.int32)
    for b, lim in enumerate(limits):
        bt[b, -(-lim // ps):] = 0
    return cp, rp, torch.tensor(bt, device="cuda")


def gather_latent(pages, bt):
    """A page arena [P, ps, W] as per-row dense caches [B, NB*ps, W]."""
    g = pages[bt.long()]
    return g.reshape(g.shape[0], -1, g.shape[-1]).contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,G,S", [
    (4, 16, 2048),     # deepseek's latent decode tick
    (3, 16, 1000),     # S no tile divides
])
def test_decode_attention_latent_kernel(dtype, B, G, S):
    rng = np.random.default_rng(1)
    q = arr(rng, B, G, R + DR, dtype=dtype)
    ckv, krope = latent_cache(rng, B, S, dtype)
    lens = [0, 1, S - 37, S][:B] if B > 3 else [0, S - 37, S][:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = dec.decode_attention.launches
    o, (m, l) = mla.decode_attention_latent(
        q, ckv, krope, kv_len=kv_len, sm_scale=MLA_SCALE,
        return_residuals=True)
    assert dec.decode_attention.launches == before + 1
    o_r, (m_r, l_r) = ref.decode_attention_latent(
        q, ckv, krope, kv_len=kv_len, sm_scale=MLA_SCALE,
        return_residuals=True)
    close(o, o_r, dtype)
    assert torch.all(o[kv_len == 0] == 0)
    close(m, m_r, torch.float32 if dtype == torch.float32 else dtype)
    np.testing.assert_allclose(l.cpu().numpy(), l_r.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,G,T,S", [
    (2, 16, 512, 2048),   # deepseek's latent prefill chunk
    (2, 16, 8, 2048),     # its short chunk (split columns)
    (2, 16, 67, 300),     # ragged T and S
])
def test_chunk_attention_latent_kernel(dtype, B, G, T, S):
    rng = np.random.default_rng(2)
    q = arr(rng, B, G, T, R + DR, dtype=dtype)
    ckv, krope = latent_cache(rng, B, S, dtype)
    pos = torch.tensor(rng.integers(0, S - T + 1, B), dtype=torch.int32,
                       device="cuda")
    pos[0] = 0
    before = dec.chunk_attention.launches
    close(mla.chunk_attention_latent(q, ckv, krope, pos=pos,
                                     sm_scale=MLA_SCALE),
          ref.chunk_attention_latent(q, ckv, krope, pos=pos,
                                     sm_scale=MLA_SCALE), dtype)
    assert dec.chunk_attention.launches == before + 1


# (B, G, T, S, pos): rows near S and rows whose pos + T passes S, G 16 and
# 32, T 1, 8, 64 and 512; the last, a short chunk deep in the cache, takes
# the split path
LATENT_CHUNK_CASES = [
    (2, 16, 64, 300, [0, 250]),        # past S
    (3, 16, 1, 700, [0, 699, 64]),     # T 1
    (1, 32, 512, 1100, [300]),         # G 32, T 512
    (8, 16, 8, 2048, [0, 5, 100, 1000, 2040, 333, 1500, 17]),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", LATENT_CHUNK_CASES)
def test_chunk_attention_latent_kernel_offsets(dtype, case):
    B, G, T, S, pos_l = case
    rng = np.random.default_rng(7)
    q = arr(rng, B, G, T, R + DR, dtype=dtype)
    ckv, krope = latent_cache(rng, B, S, dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    close(mla.chunk_attention_latent(q, ckv, krope, pos=pos,
                                     sm_scale=MLA_SCALE),
          ref.chunk_attention_latent(q, ckv, krope, pos=pos,
                                     sm_scale=MLA_SCALE), dtype)


def test_chunk_attention_latent_split_path(monkeypatch):
    """A short chunk deep in the cache splits its columns, and the merged
    output agrees with the plain version and with the same kernel run
    unsplit; two calls give the same bits."""
    B, G, T, S, pos_l = LATENT_CHUNK_CASES[-1]
    assert mla.plan(B, G, T, S, decode=False)[1] > 1
    rng = np.random.default_rng(8)
    q = arr(rng, B, G, T, R + DR, dtype=torch.bfloat16)
    ckv, krope = latent_cache(rng, B, S, torch.bfloat16)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    kw = dict(pos=pos, sm_scale=MLA_SCALE)
    split = mla.chunk_attention_latent(q, ckv, krope, **kw)
    close(split, ref.chunk_attention_latent(q, ckv, krope, **kw),
          torch.bfloat16)
    again = mla.chunk_attention_latent(q, ckv, krope, **kw)
    torch.cuda.synchronize()
    assert torch.equal(split, again)   # the merge runs in range order
    monkeypatch.setattr(dec, "chunk_splits",
                        lambda *a: (1, -(-S // dec.TILE) * dec.TILE))
    close(split, mla.chunk_attention_latent(q, ckv, krope, **kw),
          torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,G,NB,ps,apart", [
    (8, 16, 32, 64, False),   # deepseek's paged latent decode tick (TMA)
    (4, 16, 128, 16, False),  # page size 16: the gather
    (3, 16, 200, 5, False),   # page size 5
    (8, 16, 32, 64, True),    # the krope arena before the ckv arena
])
def test_decode_attention_latent_paged_kernel(dtype, B, G, NB, ps, apart):
    rng = np.random.default_rng(4)
    S = NB * ps
    lens = ([S - 37, 0, 1, S] * 2)[:B]
    cp, rp, bt = latent_paged_case(rng, B, NB, ps, lens, dtype, apart)
    q = arr(rng, B, G, R + DR, dtype=dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(kv_len=kv_len, sm_scale=MLA_SCALE)
    before = dec.decode_attention_paged.launches
    o = mla.decode_attention_latent_paged(q, cp, rp, block_table=bt, **kw)
    close(o, ref.decode_attention_latent_paged(q, cp, rp, block_table=bt,
                                               **kw), dtype)
    assert dec.decode_attention_paged.launches == before + 1
    assert torch.all(o[kv_len == 0] == 0)
    # the dense kernel on the gathered cache, and no leak from page 0
    dense = mla.decode_attention_latent(q, gather_latent(cp, bt),
                                        gather_latent(rp, bt), **kw)
    again = mla.decode_attention_latent_paged(q, scrubbed(cp), scrubbed(rp),
                                              block_table=bt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, dense) and torch.equal(o, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,G,T,NB,ps", [
    (2, 16, 512, 32, 64),   # deepseek's paged latent prefill chunk
    (2, 16, 8, 128, 16),    # its short chunk at page size 16
])
def test_chunk_attention_latent_paged_kernel(dtype, B, G, T, NB, ps):
    rng = np.random.default_rng(5)
    S = NB * ps
    pos_l = [0] + list(rng.integers(0, S - T + 1, B - 1))
    cp, rp, bt = latent_paged_case(rng, B, NB, ps, [p + T for p in pos_l],
                                   dtype)
    q = arr(rng, B, G, T, R + DR, dtype=dtype)
    kw = dict(pos=torch.tensor(pos_l, dtype=torch.int32, device="cuda"),
              sm_scale=MLA_SCALE)
    before = dec.chunk_attention_paged.launches
    o = mla.chunk_attention_latent_paged(q, cp, rp, block_table=bt, **kw)
    close(o, ref.chunk_attention_latent_paged(q, cp, rp, block_table=bt,
                                              **kw), dtype)
    assert dec.chunk_attention_paged.launches == before + 1
    again = mla.chunk_attention_latent_paged(q, scrubbed(cp), scrubbed(rp),
                                             block_table=bt, **kw)
    # one arithmetic body: the dense kernel on the gathered cache
    dense = mla.chunk_attention_latent(q, gather_latent(cp, bt),
                                       gather_latent(rp, bt), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, again) and torch.equal(o, dense)


# (B, G, T, NB, ps, pos): the gather route past S, TMA pages on the split
# path
LATENT_PAGED_CHUNK_CASES = [
    (2, 16, 64, 40, 24, [0, 700]),
    (3, 16, 8, 8, 256, [0, 2040, 900]),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", LATENT_PAGED_CHUNK_CASES)
def test_chunk_attention_latent_paged_kernel_offsets(dtype, case):
    B, G, T, NB, ps, pos_l = case
    rng = np.random.default_rng(9)
    cp, rp, bt = latent_paged_case(rng, B, NB, ps, [p + T for p in pos_l],
                                   dtype)
    q = arr(rng, B, G, T, R + DR, dtype=dtype)
    kw = dict(pos=torch.tensor(pos_l, dtype=torch.int32, device="cuda"),
              sm_scale=MLA_SCALE)
    o = mla.chunk_attention_latent_paged(q, cp, rp, block_table=bt, **kw)
    close(o, ref.chunk_attention_latent_paged(q, cp, rp, block_table=bt,
                                              **kw), dtype)
    dense = mla.chunk_attention_latent(q, gather_latent(cp, bt),
                                       gather_latent(rp, bt), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, dense)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,S", [(16, 700), (4, 300)])
def test_decode_attention_latent_kernel_lengths(dtype, G, S):
    """Decode against the plain version at empty, one-row, full and
    range-edge lengths, with the (m, l) residuals."""
    rng = np.random.default_rng(11)
    lens = decode_lengths(S, R + DR)
    B = len(lens)
    q = arr(rng, B, G, R + DR, dtype=dtype)
    ckv, krope = latent_cache(rng, B, S, dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(kv_len=kv_len, sm_scale=MLA_SCALE, return_residuals=True)
    o, (m, l) = mla.decode_attention_latent(q, ckv, krope, **kw)
    o_r, (m_r, l_r) = ref.decode_attention_latent(q, ckv, krope, **kw)
    close(o, o_r, dtype)
    assert torch.all(o[kv_len == 0] == 0)
    close(m, m_r, torch.float32 if dtype == torch.float32 else dtype)
    np.testing.assert_allclose(l.cpu().numpy(), l_r.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_latent_is_batch_invariant(dtype):
    """A row decoded alone gives exactly what it gives inside a batch of
    8 other rows, dense and paged: the split plan follows S only."""
    rng = np.random.default_rng(12)
    B, NB, ps, G = 9, 24, 64, 16
    S = NB * ps
    lens = [S, 1, 0, 700, 1023, 511, 513, 1300, 64]
    cp, rp, bt = latent_paged_case(rng, B, NB, ps, lens, dtype)
    ckv, krope = gather_latent(cp, bt), gather_latent(rp, bt)
    q = arr(rng, B, G, R + DR, dtype=dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(sm_scale=MLA_SCALE)
    batch = mla.decode_attention_latent(q, ckv, krope, kv_len=kv_len, **kw)
    paged = mla.decode_attention_latent_paged(q, cp, rp, block_table=bt,
                                              kv_len=kv_len, **kw)
    for i in (0, 3, 4, 7):
        one = slice(i, i + 1)
        alone = mla.decode_attention_latent(
            q[one], ckv[one].contiguous(), krope[one].contiguous(),
            kv_len=kv_len[one], **kw)
        alone_p = mla.decode_attention_latent_paged(
            q[one], cp, rp, block_table=bt[one].contiguous(),
            kv_len=kv_len[one], **kw)
        torch.cuda.synchronize()
        assert torch.equal(alone, batch[one]), i
        assert torch.equal(alone_p, paged[one]), i
    close(batch, ref.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                             **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T", [8, 512])
def test_chunk_attention_latent_is_batch_invariant(dtype, T):
    """A chunk row computed alone gives exactly what it gives inside a
    batch of 8 other rows, dense and paged (page size 64, TMA; 16, the
    gather): the split plan follows (G, T, S), never B."""
    rng = np.random.default_rng(13)
    B, S, G = 9, 2048, 16
    pos_l = ([2040, 0, 5, 100, 1000, 333, 1500, 17, 1900] if T == 8 else
             [1536, 0, 512, 1024, 100, 700, 1300, 7, 1000])
    q = arr(rng, B, G, T, R + DR, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    limits = [p + T for p in pos_l]
    kw = dict(sm_scale=MLA_SCALE)
    for ps in (64, 16):
        cp, rp, bt = latent_paged_case(rng, B, S // ps, ps, limits, dtype)
        ckv, krope = gather_latent(cp, bt), gather_latent(rp, bt)
        batch = mla.chunk_attention_latent(q, ckv, krope, pos=pos, **kw)
        paged = mla.chunk_attention_latent_paged(q, cp, rp, block_table=bt,
                                                 pos=pos, **kw)
        for i in (0, 3, 4, 7):
            one = slice(i, i + 1)
            alone = mla.chunk_attention_latent(
                q[one], ckv[one].contiguous(), krope[one].contiguous(),
                pos=pos[one], **kw)
            alone_p = mla.chunk_attention_latent_paged(
                q[one], cp, rp, block_table=bt[one].contiguous(),
                pos=pos[one], **kw)
            torch.cuda.synchronize()
            assert torch.equal(alone, batch[one]), (ps, i)
            assert torch.equal(alone_p, paged[one]), (ps, i)
        close(batch, ref.chunk_attention_latent(q, ckv, krope, pos=pos,
                                                **kw), dtype)
        del cp, rp, ckv, krope


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ps", [5, 16, 64])
def test_decode_attention_latent_paged_equals_dense(dtype, ps):
    """The paged instance is the dense body with other row addressing
    (TMA at page size 64, the cp.async gather at 5 and 16): on the same
    cache its output equals the dense kernel's exactly."""
    rng = np.random.default_rng(13)
    B, G = 5, 16
    NB = -(-1000 // ps)
    S = NB * ps
    lens = [S, 0, 1, 999 if S > 999 else S - 1, 257]
    cp, rp, bt = latent_paged_case(rng, B, NB, ps, lens, dtype)
    q = arr(rng, B, G, R + DR, dtype=dtype)
    kw = dict(kv_len=torch.tensor(lens, dtype=torch.int32, device="cuda"),
              sm_scale=MLA_SCALE)
    o = mla.decode_attention_latent_paged(q, cp, rp, block_table=bt, **kw)
    dense = mla.decode_attention_latent(q, gather_latent(cp, bt),
                                        gather_latent(rp, bt), **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, dense)
    close(o, ref.decode_attention_latent_paged(q, cp, rp, block_table=bt,
                                               **kw), dtype)


def test_attention_wrappers_refuse_the_latent_head_dim():
    """At head dim 576 the k/v wrappers raise on the card and name the
    latent entry points, which read the cache in place: no model path of
    either package calls them there with a v that is not the padded
    latent."""
    q = torch.zeros(2, 16, 576, dtype=torch.bfloat16, device="cuda")
    qc = torch.zeros(2, 16, 8, 576, dtype=torch.bfloat16, device="cuda")
    k = torch.zeros(2, 1, 64, 576, dtype=torch.bfloat16, device="cuda")
    pages = torch.zeros(3, 1, 64, 576, dtype=torch.bfloat16, device="cuda")
    bt = torch.ones(2, 1, dtype=torch.int32, device="cuda")
    lens = torch.tensor([3, 64], dtype=torch.int32, device="cuda")
    calls = {
        "decode_attention_latent": lambda: dec.decode_attention(
            q, k, k, kv_len=lens),
        "chunk_attention_latent": lambda: dec.chunk_attention(
            qc, k, k, pos=lens),
        "decode_attention_latent_paged": lambda: dec.decode_attention_paged(
            q, pages, pages, block_table=bt, kv_len=lens),
        "chunk_attention_latent_paged": lambda: dec.chunk_attention_paged(
            qc, pages, pages, block_table=bt, pos=lens),
    }
    before = {n: getattr(dec, n).launches for n in (
        "decode_attention", "chunk_attention", "decode_attention_paged",
        "chunk_attention_paged")}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=name):
            call()
    assert before == {n: getattr(dec, n).launches for n in before}


# ------------------------------------------------------ training kernels ----
FLASH_CASES = [
    # B, Hq, Hkv, Sq, Sk, D, causal, softcap
    (2, 32, 4, 256, 256, 64, True, 0.0),      # the training layout, G = 8
    (2, 8, 8, 200, 200, 64, True, 0.0),       # MHA (G = 1), ragged S
    (1, 16, 2, 130, 130, 128, True, 0.0),     # wide head, ragged
    (2, 8, 1, 96, 300, 64, False, 0.0),       # non-causal, Sq < Sk, MQA
    (1, 8, 2, 300, 130, 64, True, 0.0),       # causal Sq > Sk: masked rows
    (2, 8, 8, 100, 100, 64, True, 30.0),      # tanh softcap
    (1, 4, 4, 77, 77, 32, True, 0.0),
    (1, 40, 8, 384, 384, 128, True, 0.0),     # G = 5 at D 128 (qwen3 layout)
    (1, 36, 4, 301, 301, 128, True, 0.0),     # G = 9 at D 128, ragged
    (1, 48, 1, 256, 256, 128, True, 0.0),     # G = 48 (MQA) at D 128
    (1, 16, 2, 1024, 1024, 64, True, 0.0),    # many 128-row tiles on the diagonal
    (2, 8, 8, 200, 200, 80, True, 0.0),       # D 80 (zamba2's shared block), ragged
    (1, 8, 2, 130, 130, 80, True, 0.0),       # D 80 at G = 4
    (1, 8, 8, 96, 300, 80, False, 0.0),       # D 80 non-causal, Sq < Sk
    (1, 8, 8, 300, 130, 80, True, 0.0),       # D 80 causal Sq > Sk
    (1, 32, 8, 2048, 2048, 128, True, 0.0),   # phi3.5-moe's training: G 4, D 128
    (1, 48, 1, 1024, 1024, 128, True, 0.0),   # granite's training: MQA, G 48
    (1, 14, 2, 2048, 2048, 64, True, 0.0),    # internvl's training: G 7
    (1, 14, 2, 301, 301, 64, True, 0.0),      # G 7, ragged
    # seamless (G 1, D 64, non-causal): the encoder and the training
    # cross-attention, a serving chunk's cross-attention against a ragged
    # source, a short chunk against the source, Sq > Sk
    (1, 16, 16, 2048, 2048, 64, False, 0.0),
    (2, 16, 16, 128, 1000, 64, False, 0.0),
    (8, 16, 16, 8, 1024, 64, False, 0.0),
    (1, 16, 16, 300, 130, 64, False, 0.0),
]


def flash_inputs(rng, B, Hq, Hkv, Sq, Sk, D, dtype):
    return (arr(rng, B, Hq, Sq, D, dtype=dtype),
            arr(rng, B, Hkv, Sk, D, dtype=dtype),
            arr(rng, B, Hkv, Sk, D, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel(dtype, case):
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Sk, D, causal, cap = case
    q, k, v = flash_inputs(np.random.default_rng(7), B, Hq, Hkv, Sq, Sk, D,
                           dtype)
    before = fa.flash_attention.launches
    o, lse, none = fa.flash_attention(q, k, v, causal=causal,
                                      logit_softcap=cap)
    assert fa.flash_attention.launches == before + 1 and none is None
    o_r, lse_r = ref.attention(q, k, v, causal=causal, logit_softcap=cap,
                               q_offset=Sk - Sq if causal else 0,
                               return_lse=True)
    close(o, o_r, dtype)
    close(lse, lse_r, torch.float32 if dtype == torch.float32 else dtype)
    # training's forward: the same o and lse, and o before its rounding
    o_t, lse_t, o32 = fa.flash_attention(q, k, v, causal=causal,
                                         logit_softcap=cap, keep_f32=True)
    assert torch.equal(o_t, o) and torch.equal(lse_t, lse)
    assert o32.dtype == torch.float32 and torch.equal(o32.to(dtype), o)
    close(o32, o_r, dtype)
    if causal and Sq > Sk:      # rows before column 0 see nothing
        assert torch.all(o[:, :, :Sq - Sk] == 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_backward_kernel(dtype, case):
    """The backward kernel from the plain forward's (o, lse), against the
    plain backward; and two runs give the same bits (no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, Sq, Sk, D, causal, cap = case
    rng = np.random.default_rng(8)
    q, k, v = flash_inputs(rng, B, Hq, Hkv, Sq, Sk, D, dtype)
    do = arr(rng, B, Hq, Sq, D, dtype=dtype)
    opts = dict(causal=causal, logit_softcap=cap)
    o, lse = ref.attention(q, k, v, q_offset=Sk - Sq if causal else 0,
                           return_lse=True, **opts)
    before = fa.flash_attention_backward.launches
    got = fa.flash_attention_backward(q, k, v, o.float(), lse, do, **opts)
    assert fa.flash_attention_backward.launches == before + 1
    want = ref.attention_backward(q, k, v, o, lse, do,
                                  q_offset=Sk - Sq if causal else 0, **opts)
    for g, w in zip(got, want):
        close(g, w, dtype)
    again = fa.flash_attention_backward(q, k, v, o.float(), lse, do, **opts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_function_matches_autograd():
    """FlashAttention (kernels both ways) against torch autograd through
    the plain attention, f32, with an explicit sm_scale."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(9)
    q, k, v = flash_inputs(rng, 2, 8, 2, 150, 150, 64, torch.float32)
    do = arr(rng, 2, 8, 150, 64, dtype=torch.float32)
    grads = []
    for fn in (lambda *t: fa.FlashAttention.apply(*t, True, 0.2, 0.0),
               lambda *t: ref.attention(*t, causal=True, sm_scale=0.2)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ins), ins, do))
    for g, w in zip(*grads):
        close(g, w, torch.float32)


@pytest.mark.parametrize("D,G", [(64, 1), (128, 4), (80, 1)])
def test_flash_attention_bf16_grads_where_k_shares_a_component(D, G):
    """bf16 FlashAttention (kernels both ways) on K, Q and V rows that
    share one large component, as a cross-attention's K from an encoder:
    dk and dv within 2x the plain bf16 path's distance from the f64
    gradient, and dq at least 10x nearer than the backward given the
    forward's o rounded to bf16 (delta from it leaves each row's dS
    summing to ~2^-9 |dO| |o|, which times the K rows' component is dq's
    error: ~1.5 relative here).  dq stays ~50x the plain path's distance:
    o32 carries P's rounding before P V, and so delta misses sum_k P_k
    dP_k by that rounding times the component."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    Hkv, S = 2, 512
    common = 4.0 * rnd(1, 1, 1, D)
    q = (0.3 * rnd(1, Hkv * G, S, D) + 0.5 * common).to(torch.bfloat16)
    k = (0.3 * rnd(1, Hkv, S, D) + common).to(torch.bfloat16)
    v = (rnd(1, Hkv, S, D) + common).to(torch.bfloat16)
    do = rnd(1, Hkv * G, S, D).to(torch.bfloat16)
    ins64 = [a.double().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*ins64, causal=False), ins64,
                               do.double())
    rel = lambda a, b: ((a.double() - b).norm() / b.norm()).item()
    ins = [a.clone().requires_grad_() for a in (q, k, v)]
    plain = torch.autograd.grad(ref.attention(*ins, causal=False), ins, do)
    ins = [a.clone().requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(fa.FlashAttention.apply(*ins, False, None,
                                                      0.0), ins, do)
    for g, p, w in zip(got[1:], plain[1:], want[1:]):
        assert rel(g, w) <= 2.0 * rel(p, w), (rel(g, w), rel(p, w))
    o, lse, _ = fa.flash_attention(q, k, v, causal=False)
    rounded = fa.flash_attention_backward(q, k, v, o.float(), lse, do,
                                          causal=False)
    assert 10.0 * rel(got[0], want[0]) <= rel(rounded[0], want[0])


#: MLA training's pair: q/k head dim dn + dr = 192, v at dv = 128, G 1,
#: causal, sm_scale 192 ** -0.5 (B, H, Sq, Sk)
MLA_FLASH_CASES = [
    (2, 4, 256, 256),
    (1, 4, 128, 256),       # Sq < Sk: query t sees columns <= t + 128
    (1, 3, 1000, 1000),     # ragged: no tile multiple
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MLA_FLASH_CASES)
def test_flash_attention_mla_training_pair(dtype, case):
    """The (192, 128) pair: o and lse against the plain forward, dq, dk
    and dv (at 128) against the plain backward from the plain (o, lse),
    two backward launches with the same bits, and ops.attention with a
    gradient wanted going through both kernels."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, H, Sq, Sk = case
    rng = np.random.default_rng(12)
    q, k = arr(rng, B, H, Sq, 192, dtype=dtype), arr(rng, B, H, Sk, 192,
                                                     dtype=dtype)
    v, do = arr(rng, B, H, Sk, 128, dtype=dtype), arr(rng, B, H, Sq, 128,
                                                      dtype=dtype)
    opts = dict(causal=True, sm_scale=192 ** -0.5)
    o, lse, _ = fa.flash_attention(q, k, v, **opts)
    o_r, lse_r = ref.attention(q, k, v, q_offset=Sk - Sq, return_lse=True,
                               **opts)
    assert o.shape == (B, H, Sq, 128)
    close(o, o_r, dtype)
    close(lse, lse_r, torch.float32 if dtype == torch.float32 else dtype)
    got = fa.flash_attention_backward(q, k, v, o_r.float(), lse_r, do,
                                      **opts)
    want = ref.attention_backward(q, k, v, o_r, lse_r, do, q_offset=Sk - Sq,
                                  **opts)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, dtype)
    again = fa.flash_attention_backward(q, k, v, o_r.float(), lse_r, do,
                                        **opts)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    before = (fa.flash_attention.launches,
              fa.flash_attention_backward.launches)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(ops.attention(*ins, **opts), ins, do)
    assert (fa.flash_attention.launches,
            fa.flash_attention_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    for g, w in zip(grads, got):
        close(g, w, dtype)


def test_flash_attention_refuses_a_padded_mla_head_dim():
    """MLA's training attention is compiled with v at its own width, 128:
    v padded to q's 192 raises, naming the pairs that are compiled, with
    and without a gradient wanted, rather than run the plain version."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    q = torch.zeros(1, 16, 64, 192, dtype=torch.bfloat16, device="cuda")
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        ops.attention(q, q, q, causal=True, sm_scale=192 ** -0.5)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match=r"\(192, 128\)"):
        ops.attention(qg, q, q, causal=True, sm_scale=192 ** -0.5)
    assert fa.flash_attention.launches == before


def test_flash_attention_bf16_explicit_scale():
    """bf16 with an sm_scale that is not a power of two (the kernels scale
    S in f32, never q): the wrappers against the plain versions, and
    FlashAttention (kernels both ways) against torch autograd through the
    plain attention."""
    from repro_torch.kernels import flash_attention as fa
    dtype, scale = torch.bfloat16, 0.0917
    rng = np.random.default_rng(11)
    q, k, v = flash_inputs(rng, 2, 16, 4, 333, 333, 64, dtype)
    do = arr(rng, 2, 16, 333, 64, dtype=dtype)
    o, lse, _ = fa.flash_attention(q, k, v, sm_scale=scale)
    o_r, lse_r = ref.attention(q, k, v, sm_scale=scale, return_lse=True)
    close(o, o_r, dtype)
    close(lse, lse_r, dtype)
    got = fa.flash_attention_backward(q, k, v, o_r.float(), lse_r, do,
                                      sm_scale=scale)
    want = ref.attention_backward(q, k, v, o_r, lse_r, do, sm_scale=scale)
    for g, w in zip(got, want):
        close(g, w, dtype)
    grads = []
    for fn in (lambda *t: fa.FlashAttention.apply(*t, True, scale, 0.0),
               lambda *t: ref.attention(*t, causal=True, sm_scale=scale)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*ins), ins, do))
    for g, w in zip(*grads):
        close(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 300, 2048), (7, 64), (3, 5, 128),
                                   (2, 40)])
def test_rmsnorm_backward_kernel(dtype, shape):
    rng = np.random.default_rng(10)
    x = arr(rng, *shape, dtype=dtype)
    w = arr(rng, shape[-1], dtype=dtype)
    dy = arr(rng, *shape, dtype=dtype)
    before = rms.rmsnorm_backward.launches
    dx, dw = rms.rmsnorm_backward(x, w, dy, eps=1e-5)
    assert rms.rmsnorm_backward.launches == before + 1
    dx_r, dw_r = ref.rmsnorm_backward(x, w, dy, eps=1e-5)
    close(dx, dx_r, dtype)
    # dw sums over every row: compare relative to its scale
    scale = float(dw_r.float().abs().max())
    np.testing.assert_allclose(dw.float().cpu().numpy() / scale,
                               dw_r.float().cpu().numpy() / scale,
                               atol=tol(dtype), rtol=tol(dtype))
    again = rms.rmsnorm_backward(x, w, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 2048, 2048), (8, 300, 2560),
                                   (1, 2048), (1, 2560), (7, 5120),
                                   (4, 2048, 6144), (4, 2048, 896),
                                   (2, 1024, 8, 128)])
def test_rmsnorm_backward_kernel_plans(dtype, shape):
    """The backward at the train step's 8192 rows of 2048 (one block per
    SM, 8 rows in flight), at zamba2's 2560 (two warps a row), at one row
    (one block) and at rows held by three warps; at granite's and
    internvl's training rows (6144 and 896 wide) and qwen3's qk-norm rows
    of 128: against the plain version, and deterministic (two runs
    torch.equal)."""
    rng = np.random.default_rng(11)
    x = arr(rng, *shape, dtype=dtype)
    w = arr(rng, shape[-1], dtype=dtype)
    dy = arr(rng, *shape, dtype=dtype)
    dx, dw = rms.rmsnorm_backward(x, w, dy, eps=1e-5)
    dx_r, dw_r = ref.rmsnorm_backward(x, w, dy, eps=1e-5)
    close(dx, dx_r, dtype)
    scale = float(dw_r.float().abs().max())
    np.testing.assert_allclose(dw.float().cpu().numpy() / scale,
                               dw_r.float().cpu().numpy() / scale,
                               atol=tol(dtype), rtol=tol(dtype))
    again = rms.rmsnorm_backward(x, w, dy, eps=1e-5)
    torch.cuda.synchronize()
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


def test_train_step_on_the_card_matches_the_plain_path():
    """One loss_fn + backward of a small f32 model on the card, through
    the kernels and through the plain versions: the loss and every
    gradient leaf agree (the kernels sum in another order: 1e-4 relative
    L2), and the training kernels were launched."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import value_and_grad
    from repro_torch.tree import leaves_with_path

    cfg = dataclasses.replace(get_smoke("tinyllama_1_1b"), head_dim=64,
                              n_heads=8, n_kv_heads=2, d_model=256,
                              remat="dots_saveable")
    batch = SyntheticLMData(cfg, 2, 200).generate(0)
    out = {}
    for impl in ("kernel", "ref"):
        model = build_model(cfg, impl=impl, device="cuda")
        ops.reset_launch_counts()
        loss, _, _, grads = value_and_grad(model, model.init(0), batch, None)
        out[impl] = (loss, leaves_with_path(grads))
        counts = ops.launch_counts()
        if impl == "kernel":
            assert all(counts[n] > 0 for n in (
                "flash_attention", "flash_attention_backward", "rmsnorm",
                "rmsnorm_backward")), counts
    (lk, gk), (lr, gr) = out["kernel"], out["ref"]
    assert abs(float(lk) - float(lr)) <= 1e-4 * abs(float(lr))
    for (name, a), (_, b) in zip(gk, gr):
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 1e-4, (name, rel)


# -------------------------------------------------------- hybrid kernels ----
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (2, 512, 80, 64, 64, 128),   # zamba2's serving shape (two rows)
    (2, 64, 8, 32, 16, 32),      # the smoke config: chunk 32
    (3, 48, 4, 64, 64, 16),      # chunk 16
    (2, 9, 3, 64, 32, 3),        # an odd chunk
])
def test_ssd_scan_kernel(dtype, with_h0, B, L, H, P, N, chunk):
    """The SSD kernel against its plain version (ref.ssd_scan): y to the
    dtype's tolerance, in f32 with the absolute part scaled by max |y|
    (an output sums up to 128 + N products of its row's scale, and one
    near zero carries the rounding of those terms, not of itself); the
    f32 state h to 1e-3 abs + rel (f32 in both, from the same rounded
    inputs: they differ by the order of sums over L steps, a few ulp of
    values up to ~20)."""
    rng = np.random.default_rng(6)
    x = arr(rng, B, L, H, P, dtype=dtype)
    b, c = arr(rng, B, L, N, dtype=dtype), arr(rng, B, L, N, dtype=dtype)
    dt = torch.nn.functional.softplus(
        arr(rng, B, L, H, dtype=torch.float32) - 2)
    a = -torch.exp(0.5 * arr(rng, H, dtype=torch.float32))
    h0 = arr(rng, B, H, N, P, dtype=torch.float32) if with_h0 else None
    before = ms.ssd_scan.launches
    y, h = ms.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    y_r, h_r = ref.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    assert ms.ssd_scan.launches == before + 1
    torch.cuda.synchronize()
    scale = y_r.float().abs().max().item() if dtype == torch.float32 else 1.0
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_r.float().cpu().numpy(),
                               atol=tol(dtype) * scale, rtol=tol(dtype))
    np.testing.assert_allclose(h.cpu().numpy(), h_r.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (1, 512, 80, 64, 64, 128),   # one prefill row at zamba2's width
    (2, 256, 3, 64, 64, 128),    # H 3: fewer heads than a head group
    (1, 96, 6, 64, 64, 32),      # H 6: a full group and a partial one
    (2, 48, 6, 32, 16, 16),      # P 32 (one column slice), N 16
    (1, 33, 5, 64, 32, 3),       # chunk 3
    (3, 64, 9, 64, 64, 16),      # chunk 16, B 3
])
def test_ssd_scan_kernel_plans(dtype, with_h0, B, L, H, P, N, chunk):
    """The SSD kernel at batch sizes and head counts whose launch plan
    differs from the serving shape's (one head a block at B 1, partial
    head groups) and at small chunks, against its plain version; the
    tolerances of test_ssd_scan_kernel."""
    rng = np.random.default_rng(16)
    x = arr(rng, B, L, H, P, dtype=dtype)
    b, c = arr(rng, B, L, N, dtype=dtype), arr(rng, B, L, N, dtype=dtype)
    dt = torch.nn.functional.softplus(
        arr(rng, B, L, H, dtype=torch.float32) - 2)
    a = -torch.exp(0.5 * arr(rng, H, dtype=torch.float32))
    h0 = arr(rng, B, H, N, P, dtype=torch.float32) if with_h0 else None
    y, h = ms.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    y_r, h_r = ref.ssd_scan(x, dt, a, b, c, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    scale = y_r.float().abs().max().item() if dtype == torch.float32 else 1.0
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               y_r.float().cpu().numpy(),
                               atol=tol(dtype) * scale, rtol=tol(dtype))
    np.testing.assert_allclose(h.cpu().numpy(), h_r.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)


def test_ssd_scan_kernel_refuses_what_it_does_not_take():
    rng = np.random.default_rng(7)
    x = arr(rng, 1, 32, 2, 48, dtype=torch.float32)       # P = 48
    b = arr(rng, 1, 32, 16, dtype=torch.float32)
    dt = arr(rng, 1, 32, 2, dtype=torch.float32).abs()
    a = -torch.ones(2, device="cuda")
    with pytest.raises(ValueError, match="compiles"):
        ms.ssd_scan(x, dt, a, b, b, chunk=16)
    x = arr(rng, 1, 32, 2, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="chunk"):
        ms.ssd_scan(x, dt, a, b, b, chunk=12)               # 12 does not divide 32


def ssd_inputs(rng, B, L, H, P, N, dtype, with_h0):
    x = arr(rng, B, L, H, P, dtype=dtype)
    b, c = arr(rng, B, L, N, dtype=dtype), arr(rng, B, L, N, dtype=dtype)
    dt = torch.nn.functional.softplus(
        arr(rng, B, L, H, dtype=torch.float32) - 2)
    a = -torch.exp(0.5 * arr(rng, H, dtype=torch.float32))
    h0 = arr(rng, B, H, N, P, dtype=torch.float32) if with_h0 else None
    return x, dt, a, b, c, h0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("B,L,H,P,N,chunk", [
    (2, 512, 80, 64, 64, 128),   # zamba2's width, two rows
    (2, 64, 8, 32, 16, 32),      # the smoke config: chunk 32
    (1, 96, 3, 64, 32, 16),      # chunk 16
    (2, 9, 3, 64, 32, 3),        # an odd chunk
    (2, 2048, 4, 64, 64, 16),    # 128 chunks of state passing
    (1, 128, 8, 64, 64, 128),    # a single chunk (L == chunk)
    (4, 2048, 80, 64, 64, 128),  # zamba2's training width at B 4
])
def test_ssd_scan_backward_kernel(dtype, with_h0, with_dh, B, L, H, P, N,
                                  chunk):
    """The SSD backward kernel against its plain version
    (ref.ssd_scan_backward), both f32 from the same inputs: each gradient
    to the dtype's tolerance, the absolute part scaled by its largest
    entry (dt, dA and the dB, dC sums collect many terms of their rows'
    scale); two launches give the same bits (no atomics)."""
    rng = np.random.default_rng(26)
    x, dt, a, b, c, h0 = ssd_inputs(rng, B, L, H, P, N, dtype, with_h0)
    dy = arr(rng, B, L, H, P, dtype=dtype)
    dh = arr(rng, B, H, N, P, dtype=torch.float32) if with_dh else None
    before = ms.ssd_scan_backward.launches
    got = ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    assert ms.ssd_scan_backward.launches == before + 1
    want = ref.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert (got[5] is None) == (h0 is None)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want):
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        t = tol(dtype)
        scale = w.float().abs().max().item()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=t * scale,
                                   rtol=t, err_msg=name)
    again = ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("H,hg", [(5, 2), (5, 4), (3, 2), (80, 3)])
def test_ssd_scan_backward_kernel_groups(monkeypatch, with_h0, H, hg):
    """The bf16 backward with head groups that do not divide H (the last
    group holds fewer heads), the group forced through the planner: each
    gradient to the bf16 tolerance of test_ssd_scan_backward_kernel, and
    two launches give the same bits."""
    B, L, P, N, chunk = 2, 256, 64, 64, 64
    monkeypatch.setattr(ms, "ssd_bwd_plan", lambda *_: (hg, -(-H // hg)))
    rng = np.random.default_rng(28)
    x, dt, a, b, c, h0 = ssd_inputs(rng, B, L, H, P, N, torch.bfloat16,
                                    with_h0)
    dy = arr(rng, B, L, H, P, dtype=torch.bfloat16)
    dh = arr(rng, B, H, N, P, dtype=torch.float32) if with_h0 else None
    got = ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    want = ref.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want):
        if w is None:
            continue
        t = tol(torch.bfloat16)
        scale = w.float().abs().max().item()
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), atol=t * scale,
                                   rtol=t, err_msg=name)
    again = ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert all(g is None or torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_backward_kernel_elementwise(with_h0):
    """The bf16 backward at zamba2's training shape, each entry of each
    gradient within 2e-2 abs + rel of the plain version (chip_smoke.py's
    check, with no scaling by the largest entry): d(dtx) = S^T dy and the
    dB, dC terms of the summed dG hold it only with S and dG entering as
    bf16 high + low parts."""
    B, L, H, P, N, chunk = 4, 2048, 80, 64, 64, 128
    rng = np.random.default_rng(29)
    x, dt, a, b, c, h0 = ssd_inputs(rng, B, L, H, P, N, torch.bfloat16,
                                    with_h0)
    dy = arr(rng, B, L, H, P, dtype=torch.bfloat16)
    dh = arr(rng, B, H, N, P, dtype=torch.float32) if with_h0 else None
    got = ms.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    want = ref.ssd_scan_backward(x, dt, a, b, c, h0, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    t = tol(torch.bfloat16)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dh0"), got, want):
        if w is not None:
            np.testing.assert_allclose(g.float().cpu().numpy(),
                                       w.float().cpu().numpy(), atol=t,
                                       rtol=t, err_msg=name)


def test_ssd_scan_backward_kernel_fills_the_card():
    """The bf16 backward's chunk-gradient launch keeps two blocks on an SM
    at every head group the planner may choose, at zamba2's width."""
    for hg in range(1, ms.MAX_BWD_HEADS + 1):
        assert ms.ssd_bwd_occupancy(64, 64, hg) >= 2, hg


def test_ssd_scan_function_matches_autograd():
    """SSDScan (both kernels) against torch autograd through the plain
    chunked scan, f32, with a carried state and a gradient of h_final."""
    rng = np.random.default_rng(27)
    x, dt, a, b, c, h0 = ssd_inputs(rng, 2, 96, 4, 32, 16, torch.float32,
                                    True)
    dy = arr(rng, 2, 96, 4, 32, dtype=torch.float32)
    dh = arr(rng, 2, 4, 16, 32, dtype=torch.float32)
    grads = []
    for fn in (lambda *t: ms.SSDScan.apply(*t, 32),
               lambda *t: ref.ssd_chunked(*t[:5], chunk=32, h0=t[5])):
        ins = [t.clone().requires_grad_() for t in (x, dt, a, b, c, h0)]
        y, h = fn(*ins)
        grads.append(torch.autograd.grad((y, h), ins, (dy, dh)))
    for g, w in zip(*grads):
        scale = w.abs().max().item()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("name", [
    "decode_attention", "chunk_attention", "decode_attention_paged",
    "chunk_attention_paged", "decode_attention_latent",
    "chunk_attention_latent", "decode_attention_latent_paged",
    "chunk_attention_latent_paged", "rmsnorm_add"])
def test_kernel_without_a_backward_refuses_a_gradient(name):
    """On the card a kernel with no backward raises when a gradient is
    wanted, rather than return outputs cut from the graph; under no_grad
    it runs."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(28)
    q = arr(rng, 2, 4, 64, dtype=torch.float32).requires_grad_()
    k = arr(rng, 2, 2, 128, 64, dtype=torch.float32)
    qc = arr(rng, 2, 4, 8, 64, dtype=torch.float32).requires_grad_()
    pages = arr(rng, 9, 2, 16, 64, dtype=torch.float32)
    bt = torch.arange(1, 9, dtype=torch.int32, device="cuda").reshape(2, 4)
    lens = torch.tensor([5, 64], dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 40], dtype=torch.int32, device="cuda")
    x = arr(rng, 3, 64, dtype=torch.float32).requires_grad_()
    w = arr(rng, 64, dtype=torch.float32)
    ql = arr(rng, 2, 16, R + DR, dtype=torch.float32).requires_grad_()
    qlc = arr(rng, 2, 16, 8, R + DR, dtype=torch.float32).requires_grad_()
    ckv, krope = latent_cache(rng, 2, 128, torch.float32)
    cp, rp = latent_cache(rng, 9, 16, torch.float32)
    call = {
        "decode_attention": lambda: ops.decode_attention(q, k, k,
                                                         kv_len=lens),
        "chunk_attention": lambda: ops.chunk_attention(qc, k, k, pos=pos),
        "decode_attention_paged": lambda: ops.decode_attention_paged(
            q, pages, pages, block_table=bt, kv_len=lens),
        "chunk_attention_paged": lambda: ops.chunk_attention_paged(
            qc, pages, pages, block_table=bt, pos=pos),
        "rmsnorm_add": lambda: ops.rmsnorm_add(x, x.detach(), w),
        "decode_attention_latent": lambda: ops.decode_attention_latent(
            ql, ckv, krope, kv_len=lens),
        "chunk_attention_latent": lambda: ops.chunk_attention_latent(
            qlc, ckv, krope, pos=pos),
        "decode_attention_latent_paged":
            lambda: ops.decode_attention_latent_paged(
                ql, cp, rp, block_table=bt, kv_len=lens),
        "chunk_attention_latent_paged":
            lambda: ops.chunk_attention_latent_paged(
                qlc, cp, rp, block_table=bt, pos=pos),
    }[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    with torch.no_grad():
        call()
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 512, 2560), (3, 40), (2, 5, 128)])
def test_rmsnorm_add_kernel(dtype, shape):
    rng = np.random.default_rng(8)
    x, r = arr(rng, *shape, dtype=dtype), arr(rng, *shape, dtype=dtype)
    w = arr(rng, shape[-1], dtype=dtype)
    before = rms.rmsnorm_add.launches
    (y, s), (y_r, s_r) = rms.rmsnorm_add(x, r, w), ref.rmsnorm_add(x, r, w)
    assert rms.rmsnorm_add.launches == before + 1
    close(s, s_r, dtype)
    close(y, y_r, dtype)


def test_hybrid_engine_on_the_card_matches_the_plain_path():
    """The hybrid smoke model (f32) served on the card through the kernels
    gives the same greedy tokens as the plain versions on the card; the
    kernels of its path (ssd_scan, rmsnorm, chunk and decode attention)
    were launched, the paged pair never (max_cache_pages keeps the dense
    layout)."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine

    cfg = get_smoke("zamba2_2_7b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (3, 17, 40, 9)]
    outs = {}
    for impl, pages in (("kernel", 0), ("kernel", 40), ("ref", 0)):
        model = build_model(cfg, impl=impl, device="cuda")
        engine = ServingEngine(model, model.init(0), ServeConfig(
            max_batch=3, max_seq_len=96, prefill_chunk=16, eos_token=-1,
            min_chunk_bucket=4, page_size=8, max_cache_pages=pages))
        assert not engine.paged
        ops.reset_launch_counts()
        reqs = [engine.submit(p, 6) for p in prompts]
        engine.run_until_drained()
        outs[impl, pages] = [r.output for r in reqs]
        counts = ops.launch_counts()
        if impl == "kernel":
            assert all(counts[n] > 0 for n in (
                "ssd_scan", "rmsnorm", "chunk_attention",
                "decode_attention")), counts
            assert counts["chunk_attention_paged"] == 0 \
                and counts["decode_attention_paged"] == 0, counts
        else:
            assert not any(counts.values()), counts
    assert len({str(o) for o in outs.values()}) == 1, outs


def test_gloo_send_recv_of_cuda_tensors_on_two_ranks_sharing_the_card(
        tmp_path):
    """A gloo world of 2 ranks on one card: `parallel.mesh.send` and
    `recv` carry bf16 and f32 CUDA tensors, and a transposed bf16 view
    into a transposed buffer, both ways (through host copies: gloo's
    point-to-point calls take CPU tensors), bit for bit, into CUDA
    buffers."""
    import torch_mesh_worlds as worlds
    procs = worlds.start_world("p2p_cuda", 2, str(tmp_path))
    worlds.join(procs, str(tmp_path), "p2p_cuda")
    ranks = [torch.load(tmp_path / f"p2p_cuda-rank{r}.pt")
             for r in range(2)]
    for name, _, transposed in worlds.P2P_CASES:
        for r in range(2):
            got, sent = ranks[r][name]["got"], ranks[1 - r][name]["sent"]
            assert ranks[r][name]["device"].startswith("cuda")
            assert sent.is_contiguous() != transposed, name
            assert got.dtype == sent.dtype and torch.equal(got, sent), \
                (name, r)


def test_tensor_parallel_layer_on_two_ranks_sharing_the_card(tmp_path):
    """A gloo world of 2 ranks on one card: tinyllama_1_1b's embedding,
    first decoder layer and final norm at full width, tensor parallel 2
    (16 q over 2 kv heads a rank, G 8 as on one rank), against the
    one-rank kernel forward; both ranks launch the rmsnorm and flash
    kernels on their shards."""
    import torch_mesh_worlds as worlds
    procs = worlds.start_world("layer_cuda", 2, str(tmp_path))
    worlds.join(procs, str(tmp_path), "layer_cuda")
    ranks = [torch.load(tmp_path / f"layer_cuda-rank{r}.pt")
             for r in range(2)]
    want = ranks[0]["want"]
    for r in ranks:
        np.testing.assert_allclose(r["got"].numpy(), want.numpy(),
                                   atol=2e-2, rtol=2e-2)
        assert r["launches"]["rmsnorm"] == 3
        assert r["launches"]["flash_attention"] == 1
