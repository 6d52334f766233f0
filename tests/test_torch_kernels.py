"""The port's plain kernel versions against the JAX package, on the CPU.

Same numpy inputs through `repro_torch.kernels` and through the JAX
package's oracles (`repro.kernels.ref`) and Pallas kernels in interpret
mode (`repro.kernels.ops(..., impl="pallas", interpret=True)`).
Tolerances are tests/test_kernels.py::tol: 2e-5 in f32, 2e-2 in bf16.

One case is pinned to the Pallas kernel, not the oracle: a decode row
with kv_len == 0 gives zeros (m = -1e30, l = 0), where the JAX oracle's
finite mask gives the mean of v.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as trms

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return 2e-2 if name == "bf16" else 2e-5


def pair(rng, *shape, dt="f32"):
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dt]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def close(t, j, dt, rows=slice(None)):
    np.testing.assert_allclose(t.float().numpy()[rows],
                               np.asarray(j, np.float32)[rows],
                               atol=tol(dt), rtol=tol(dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 128), (5, 2048)])
def test_rmsnorm(dt, shape):
    rng = np.random.default_rng(0)
    jx, tx = pair(rng, *shape, dt=dt)
    jw, tw = pair(rng, shape[-1], dt=dt)
    got = tops.rmsnorm(tx, tw, eps=1e-5, impl="ref")
    close(got, jref.rmsnorm(jx, jw, eps=1e-5), dt)
    close(got, jops.rmsnorm(jx, jw, eps=1e-5, impl="pallas", interpret=True),
          dt)


DEC_SHAPES = [
    # B, Hq, Hkv, S, D, kv_len
    (3, 8, 2, 256, 64, (0, 1, 256)),       # GQA, empty + full rows
    (3, 8, 1, 300, 32, (7, 0, 299)),       # MQA, S no power of two
    (2, 4, 4, 128, 32, (128, 65)),         # MHA
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", DEC_SHAPES)
def test_decode_attention(dt, shape):
    B, Hq, Hkv, S, D, lens = shape
    rng = np.random.default_rng(1)
    jq, tq = pair(rng, B, Hq, D, dt=dt)
    jk, tk = pair(rng, B, Hkv, S, D, dt=dt)
    jv, tv = pair(rng, B, Hkv, S, D, dt=dt)
    jl = jnp.asarray(lens, jnp.int32)
    tl = torch.tensor(lens, dtype=torch.int32)
    o, (m, l) = tops.decode_attention(tq, tk, tv, kv_len=tl, impl="ref",
                                      return_residuals=True)
    po, (pm, pl) = jops.decode_attention(jq, jk, jv, kv_len=jl,
                                         impl="pallas", interpret=True,
                                         return_residuals=True)
    close(o, po, dt)
    np.testing.assert_allclose(m.numpy(), np.asarray(pm), rtol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(pl), rtol=1e-4,
                               atol=1e-4)
    # the oracle agrees wherever the row is not empty
    ro, (rm, rl) = jref.decode_attention(jq, jk, jv, kv_len=jl,
                                         return_residuals=True)
    full = np.asarray(lens) > 0
    close(o, ro, dt, rows=full)
    np.testing.assert_allclose(l.numpy()[full], np.asarray(rl)[full],
                               rtol=1e-4)
    # empty rows are exact zeros, as the Pallas kernel gives them
    assert torch.all(o[torch.tensor(~full)] == 0)


def test_combine_decode_partials():
    """Split-K over two halves of S merges back to the whole-S decode."""
    rng = np.random.default_rng(2)
    B, Hq, Hkv, S, D = 2, 8, 2, 128, 32
    jq, tq = pair(rng, B, Hq, D)
    jk, tk = pair(rng, B, Hkv, S, D)
    jv, tv = pair(rng, B, Hkv, S, D)
    parts = [tref.decode_attention(tq, tk[:, :, h:h + 64], tv[:, :, h:h + 64],
                                   return_residuals=True) for h in (0, 64)]
    o = torch.stack([p[0] for p in parts])
    m = torch.stack([p[1][0] for p in parts])
    l = torch.stack([p[1][1] for p in parts])
    got = tref.combine_decode_partials(o, m, l)
    close(got, jref.combine_decode_partials(
        jnp.asarray(o.numpy()), jnp.asarray(m.numpy()),
        jnp.asarray(l.numpy())), "f32")
    close(got, jref.decode_attention(jq, jk, jv), "f32")


CHUNK_SHAPES = [
    # B, Hq, Hkv, T, S, D
    (2, 8, 2, 5, 64, 32),       # GQA, odd chunk width
    (3, 4, 1, 8, 128, 64),      # MQA
    (2, 2, 2, 16, 96, 32),      # MHA, S no power of two
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
def test_chunk_attention(dt, shape):
    B, Hq, Hkv, T, S, D = shape
    rng = np.random.default_rng(3)
    jq, tq = pair(rng, B, Hq, T, D, dt=dt)
    jk, tk = pair(rng, B, Hkv, S, D, dt=dt)
    jv, tv = pair(rng, B, Hkv, S, D, dt=dt)
    pos = rng.integers(0, S - T + 1, B).astype(np.int32)
    pos[0] = 0
    got = tops.chunk_attention(tq, tk, tv, pos=torch.from_numpy(pos),
                               impl="ref")
    close(got, jref.chunk_attention(jq, jk, jv, pos=jnp.asarray(pos)), dt)
    close(got, jops.chunk_attention(jq, jk, jv, pos=jnp.asarray(pos),
                                    impl="pallas", interpret=True), dt)


def test_chunk_of_one_is_decode():
    """T == 1 at pos is decode attention with kv_len = pos + 1."""
    rng = np.random.default_rng(4)
    _, tq = pair(rng, 2, 4, 1, 32)
    _, tk = pair(rng, 2, 2, 40, 32)
    _, tv = pair(rng, 2, 2, 40, 32)
    pos = torch.tensor([3, 39], dtype=torch.int32)
    a = tref.chunk_attention(tq, tk, tv, pos=pos)[:, :, 0]
    b = tref.decode_attention(tq[:, :, 0], tk, tv, kv_len=pos + 1)
    torch.testing.assert_close(a, b, atol=2e-6, rtol=2e-6)


class TestDispatch:
    def test_auto_on_cpu_runs_the_plain_version_without_launching(self):
        rng = np.random.default_rng(5)
        _, x = pair(rng, 3, 64)
        _, w = pair(rng, 64)
        before = dict(tops.launch_counts())
        torch.testing.assert_close(tops.rmsnorm(x, w, impl="auto"),
                                   tref.rmsnorm(x, w), rtol=0, atol=0)
        _, q = pair(rng, 2, 4, 32)
        _, k = pair(rng, 2, 2, 16, 32)
        torch.testing.assert_close(
            tops.decode_attention(q, k, k, impl="auto"),
            tref.decode_attention(q, k, k), rtol=0, atol=0)
        assert tops.launch_counts() == before

    @pytest.mark.parametrize("call", ["rmsnorm", "decode", "chunk"])
    def test_kernel_impl_refuses_cpu_tensors(self, call):
        x = torch.zeros(2, 4, 3, 32)
        pos = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            if call == "rmsnorm":
                tops.rmsnorm(x, torch.ones(32), impl="kernel")
            elif call == "decode":
                tops.decode_attention(x[:, :, 0], x, x, impl="kernel")
            else:
                tops.chunk_attention(x, x, x, pos=pos, impl="kernel")

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="impl"):
            tops.rmsnorm(torch.zeros(2, 8), torch.ones(8), impl="pallas")

    @pytest.mark.parametrize("B,Hkv,S,want", [
        (8, 4, 2048, (8, 256)),      # the serving decode tick on 132 SMs
        (1, 1, 2048, (32, 64)),      # one row: a range per tile
        (1, 1, 8192, (64, 128)),     # capped at MAX_SPLITS ranges
        (64, 8, 2048, (1, 2048)),    # enough rows already: no split
        (3, 1, 1000, (16, 64)),      # ragged S: the last range is short
    ])
    def test_decode_splits_cover_s_in_whole_tiles(self, B, Hkv, S, want):
        nsplit, rows = tdec.decode_splits(B, Hkv, S, sms=132)
        assert (nsplit, rows) == want
        assert rows % tdec.TILE == 0 and nsplit <= tdec.MAX_SPLITS
        assert (nsplit - 1) * rows < S <= nsplit * rows

    def test_wrappers_check_before_launching(self):
        """The CUDA path validates without a card: a CPU tensor never
        reaches it, and the checks name what is wrong."""
        with pytest.raises(ValueError, match="CUDA tensor"):
            trms.check_cuda(torch.zeros(2), "rmsnorm")
        with pytest.raises(ValueError, match="multiple of 8"):
            trms.check_vectors(12, torch.zeros(12, dtype=torch.bfloat16))
        assert tdec.HEAD_DIMS == (32, 64, 128)
