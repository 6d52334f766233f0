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
from repro_torch.kernels import mamba_scan as tssd
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
    (2, 4, 4, 16, 96, 80),      # zamba2's shared block: G 1, head dim 80
    (3, 40, 8, 9, 77, 128),     # G 5, S no tile multiple (ragged tail)
    (3, 8, 2, 1, 64, 64),       # T 1: a decode step through the chunk path
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
        (8, 4, 2048, (4, 512)),      # the serving decode tick
        (1, 1, 2048, (4, 512)),      # one row: the same ranges
        (1, 1, 8192, (16, 512)),     # a longer cache: more ranges
        (64, 8, 2048, (4, 512)),     # many rows: still the same ranges
        (3, 1, 1000, (2, 512)),      # ragged S: the last range is short
    ])
    def test_decode_splits_cover_s_in_whole_tiles(self, B, Hkv, S, want):
        nsplit, rows = tdec.decode_splits(S)
        assert (nsplit, rows) == want
        assert rows % tdec.TILE == 0 and nsplit <= tdec.MAX_SPLITS
        assert (nsplit - 1) * rows < S <= nsplit * rows
        # the launch plan takes these ranges at every batch size
        _, n, r, _ = tdec.decode_plan(B, Hkv, 8, S, 64)
        assert (n, r) == want

    @pytest.mark.parametrize("S", [1, 63, 64, 65, 300, 1000, 2048, 4095,
                                   16384, 16385, 70000])
    def test_decode_plan_is_the_same_for_every_batch(self, S):
        """The decode ranges cover [0, S) in whole tiles, at most
        MAX_SPLITS of them, and depend on S only: every batch size, kv
        head count and group size gets the same ranges, so a row's output
        cannot depend on the rows beside it."""
        plans = {tdec.decode_plan(B, Hkv, G, S, D)[1:3]
                 for B in (1, 2, 3, 8, 64) for Hkv in (1, 4, 32)
                 for G in (1, 5, 8, 16, 20) for D in (32, 64, 80, 128)}
        assert len(plans) == 1
        nsplit, rows = plans.pop()
        assert rows % tdec.TILE == 0 and 1 <= nsplit <= tdec.MAX_SPLITS
        ranges = [(i * rows, min(S, (i + 1) * rows)) for i in range(nsplit)]
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        assert all(a % tdec.TILE == 0 and a < z for a, z in ranges)
        assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))
        # a row of kv_len n runs the ranges that start below n (one if empty)
        for n in {min(S, n) for n in (0, 1, rows - 1, rows, rows + 1, S)}:
            active = max(1, -(-n // rows))
            assert active <= nsplit and (n == 0 or (active - 1) * rows < n)

    def test_decode_plan_sizes_its_scratch(self):
        """One partial of min(G, 16) rows of (acc, m, l) per (row, kv head,
        group of 16 q heads) and range; none when one range covers S."""
        assert tdec.decode_plan(8, 4, 8, 2048, 64) == (32, 4, 512,
                                                       32 * 4 * 8 * 66)
        assert tdec.decode_plan(8, 32, 1, 2048, 80) == (256, 4, 512,
                                                        256 * 4 * 82)
        assert tdec.decode_plan(2, 2, 20, 1000, 64) == (8, 2, 512,
                                                        8 * 2 * 16 * 66)
        assert tdec.decode_plan(4, 4, 8, 200, 64)[1:] == (1, 512, 0)

    def test_scratch_is_reused_and_grown(self):
        """The split merges' scratch is kept per device: asked for no more
        than it holds, the same tensors come back (no new allocation, no
        memset); asked for more, it grows, with fresh zero counters."""
        dev = torch.device("cpu")
        tdec._SCRATCH.pop(dev, None)
        try:
            part, done = tdec.scratch(dev, 100, 10)
            assert part.dtype == torch.float32 and part.numel() >= 100
            assert done.dtype == torch.int32 and done.numel() >= 10
            assert not done.any()
            again = tdec.scratch(dev, 50, 3)
            assert again[0] is part and again[1] is done
            grown = tdec.scratch(dev, 1000, 40)
            assert grown[0].numel() >= 1000 and grown[1].numel() >= 40
            assert grown[1] is not done and not grown[1].any()
        finally:
            tdec._SCRATCH.pop(dev, None)

    @pytest.mark.parametrize("B,H,P", [(8, 80, 64), (1, 80, 64), (2, 80, 64),
                                       (1, 3, 64), (3, 6, 32), (2, 5, 32),
                                       (64, 80, 64)])
    def test_ssd_plan_covers_every_head_once(self, B, H, P):
        """The bf16 SSD kernel's blocks (batch row, head group, 32 columns
        of P) cover every (row, head, column) exactly once; at the serving
        width (H 80, P 64) every SM gets a block even at B 1."""
        hg, groups, slices = tssd.ssd_plan(B, H, P, sms=132)
        assert 1 <= hg <= tssd.MAX_HEADS and slices * tssd.HEAD_COLS == P
        seen = np.zeros((B, H, P), dtype=int)
        for g in range(groups):
            heads = range(g * hg, min(H, (g + 1) * hg))
            assert len(heads) >= 1
            for b in range(B):
                for z in range(slices):
                    for h in heads:
                        seen[b, h, z * tssd.HEAD_COLS:
                             (z + 1) * tssd.HEAD_COLS] += 1
        assert (seen == 1).all()
        if (H, P) == (80, 64):
            assert B * groups * slices >= 132

    @pytest.mark.parametrize("B,Hkv,G,T,S,want", [
        (8, 4, 8, 8, 2048, (8, 256)),     # a short chunk deep in the cache
        (8, 4, 8, 512, 2048, (1, 2048)),  # the prefill chunk: 1024 blocks
        (8, 32, 1, 512, 2048, (1, 2048)), # zamba2's shared block: 1024
        (8, 4, 8, 1, 2048, (8, 256)),     # T 1: one tile of 8 rows
        (2, 32, 1, 8, 2048, (5, 448)),    # G 1, T 8: 64 blocks
        (1, 1, 1, 1, 8192, (64, 128)),    # capped at MAX_SPLITS ranges
        (3, 2, 5, 7, 300, (5, 64)),       # ragged S: the last range is short
    ])
    def test_chunk_splits_cover_s_in_whole_tiles(self, B, Hkv, G, T, S,
                                                 want):
        nsplit, cols = tdec.chunk_splits(B, Hkv, G, T, S, sms=132)
        assert (nsplit, cols) == want
        assert cols % tdec.TILE == 0 and 1 <= nsplit <= tdec.MAX_SPLITS
        assert (nsplit - 1) * cols < S <= nsplit * cols
        # a split grid gives every SM a block at least, unless the ranges
        # are capped or already one tile each
        blocks = B * Hkv * -(-G * T // tdec.CHUNK_ROWS)
        assert nsplit == 1 or blocks * nsplit >= 132 \
            or nsplit in (tdec.MAX_SPLITS, -(-S // tdec.TILE))
        # a query tile whose rows see columns [0, ncols) runs the ranges
        # that start below ncols: whole tiles, disjoint, covering them
        for ncols in {1, 63, 64, 65, S // 2, S - 1, S}:
            active = max(1, -(-ncols // cols))
            assert active <= nsplit
            ranges = [(r * cols, min(ncols, (r + 1) * cols))
                      for r in range(active)]
            assert ranges[0][0] == 0 and ranges[-1][1] == ncols
            assert all(a % tdec.TILE == 0 and a < z for a, z in ranges)
            assert all(z == a2 for (_, z), (a2, _) in zip(ranges, ranges[1:]))

    def test_chunk_splits_only_when_the_grid_is_short(self):
        """No split once the query tiles alone give two blocks per SM;
        below that, at least one block per SM unless every range is one
        tile already."""
        for B in (1, 2, 4, 8, 16, 64):
            for T in (1, 8, 64, 128, 512):
                nsplit, _ = tdec.chunk_splits(B, 4, 8, T, 2048, sms=132)
                blocks = B * 4 * -(-8 * T // tdec.CHUNK_ROWS)
                if blocks >= 2 * 132:
                    assert nsplit == 1
                else:
                    assert nsplit > 1
                    assert blocks * nsplit >= 132 \
                        or nsplit == 2048 // tdec.TILE

    def test_wrappers_check_before_launching(self):
        """The CUDA path validates without a card: a CPU tensor never
        reaches it, and the checks name what is wrong."""
        with pytest.raises(ValueError, match="CUDA tensor"):
            trms.check_cuda(torch.zeros(2), "rmsnorm")
        with pytest.raises(ValueError, match="multiple of 8"):
            trms.check_vectors(12, torch.zeros(12, dtype=torch.bfloat16))
        assert tdec.HEAD_DIMS == (32, 64, 80, 128)
