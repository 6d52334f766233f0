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
from repro_torch.kernels import mla_attention as tmla
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

    @pytest.mark.parametrize("B,L,H,chunk", [
        (4, 2048, 80, 128),   # zamba2's training shape
        (1, 512, 80, 128),    # one row
        (2, 2048, 4, 16),     # 128 chunks
        (1, 128, 8, 128),     # a single chunk
        (2, 256, 5, 64),      # H 5
        (3, 96, 3, 32),       # H 3
        (2, 9, 3, 3),         # an odd chunk
    ])
    def test_ssd_bwd_plan_covers_every_chunk_once(self, B, L, H, chunk):
        """The bf16 SSD backward's blocks (batch row, chunk, head group)
        cover every (row, chunk, head) exactly once, and its scratch has
        the shapes the kernel indexes; at the training shape every SM gets
        two blocks at least twice over, and the dB/dC parts are smaller
        than the per-head parts of the f32 kernel."""
        P, N = 64, 64
        hg, groups = tssd.ssd_bwd_plan(B, L, H, chunk, sms=132)
        assert 1 <= hg <= tssd.MAX_BWD_HEADS and groups == -(-H // hg)
        nc = L // chunk
        seen = np.zeros((B, nc, H), dtype=int)
        for g in range(groups):
            heads = range(g * hg, min(H, (g + 1) * hg))
            assert len(heads) >= 1
            for b in range(B):
                for k in range(nc):
                    seen[b, k, list(heads)] += 1
        assert (seen == 1).all()
        shapes = tssd.ssd_bwd_scratch(B, L, H, P, N, chunk, hg)
        assert shapes == {"states": (B, nc, H, N, P),
                          "dstates": (B, nc, H, N, P),
                          "decay": (B, nc, H), "dap": (B, nc, H),
                          "dbp": (B, groups, L, N), "dcp": (B, groups, L, N)}
        if (B, L, H, chunk) == (4, 2048, 80, 128):
            assert B * nc * groups >= 2 * 2 * 132
            assert groups < H

    @pytest.mark.parametrize("B,Hkv,G,T,S,want", [
        (8, 4, 8, 8, 2048, (8, 256)),     # a short chunk deep in the cache
        (8, 4, 8, 512, 2048, (1, 2048)),  # the prefill chunk: 128 blocks a row
        (8, 32, 1, 512, 2048, (1, 2048)), # zamba2's shared block: 128
        (8, 4, 8, 1, 2048, (8, 256)),     # T 1: one tile of 8 rows
        (2, 32, 1, 8, 2048, (2, 1024)),   # G 1, T 8: 32 blocks a row
        (1, 1, 1, 1, 8192, (32, 256)),    # one block a row: 33 ranges wanted
        (3, 2, 5, 7, 300, (5, 64)),       # ragged S: the last range is short
    ])
    def test_chunk_splits_cover_s_in_whole_tiles(self, B, Hkv, G, T, S,
                                                 want):
        nsplit, cols = tdec.chunk_splits(Hkv, G, T, S)
        assert (nsplit, cols) == want
        assert cols % tdec.TILE == 0 and 1 <= nsplit <= tdec.MAX_SPLITS
        assert (nsplit - 1) * cols < S <= nsplit * cols
        # the launch plan takes these ranges at this batch size too
        assert tdec.chunk_plan(B, Hkv, G, T, S, 64)[1:3] == want
        # a split row gives a full group of 8 rows a block per SM at least,
        # unless the ranges are capped or already one tile each
        per_row = Hkv * -(-G * T // tdec.CHUNK_ROWS)
        assert nsplit == 1 or 8 * per_row * nsplit >= 132 \
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
        """No split once a row's query tiles alone give CHUNK_ROW_BLOCKS
        blocks; below that, a row's blocks times its ranges reach
        CHUNK_ROW_BLOCKS within one range's rounding, unless every range
        is one tile already."""
        for Hkv in (1, 4, 8, 32):
            for G in (1, 5, 8):
                for T in (1, 8, 64, 128, 512):
                    nsplit, cols = tdec.chunk_splits(Hkv, G, T, 2048)
                    per_row = Hkv * -(-G * T // tdec.CHUNK_ROWS)
                    if per_row >= tdec.CHUNK_ROW_BLOCKS:
                        assert nsplit == 1
                    else:
                        assert nsplit > 1
                        want = -(-tdec.CHUNK_ROW_BLOCKS // per_row)
                        assert nsplit == 2048 // tdec.TILE or \
                            want / 2 < nsplit <= want

    @pytest.mark.parametrize("B", [1, 2, 3, 8, 64])
    @pytest.mark.parametrize("T", [1, 8, 16, 64, 512])
    @pytest.mark.parametrize("S", [64, 300, 2048, 8192])
    def test_chunk_plan_is_the_same_for_every_batch(self, B, T, S):
        """The chunk ranges follow (Hkv, G, T, S) alone: a batch of B rows
        gets the ranges of one row, so a row's chunk output cannot depend
        on the rows beside it; only the grid and the partials scale with
        B."""
        for Hkv, G, D in ((4, 8, 64), (32, 1, 80), (8, 5, 128), (1, 16, 64)):
            blocks, nsplit, cols, part = tdec.chunk_plan(B, Hkv, G, T, S, D)
            one = tdec.chunk_plan(1, Hkv, G, T, S, D)
            assert (nsplit, cols) == one[1:3] \
                == tdec.chunk_splits(Hkv, G, T, S)
            assert blocks == B * one[0]
            assert part == B * one[3]
            assert (part == 0) == (nsplit == 1)

    @pytest.mark.parametrize("S,want", [
        (2048, (8, 256)),     # deepseek's decode tick: 64 blocks for 8 rows
        (1000, (4, 256)),     # ragged S: the last range is short
        (16384, (64, 256)),   # a longer cache: ranges capped at MAX_SPLITS
        (1, (1, 256)),
    ])
    def test_wide_decode_splits_follow_s_alone(self, S, want):
        """At D 576 decode cuts S into shorter ranges (one latent kv head
        gives one block a row and range), the same for every batch."""
        assert tdec.decode_splits(S, 576) == want
        plans = {tmla.plan(B, G, 1, S, decode=True)
                 for B in (1, 8) for G in (4, 16)}
        assert {p[1:3] for p in plans} == {want}
        for blocks, nsplit, rows, part in plans:
            # the latent kernel's partials: 64 rows of (acc [512], m, l)
            # a block and range
            assert part == (blocks * nsplit * tmla.ROWS * 514
                            if nsplit > 1 else 0)

    @pytest.mark.parametrize("T,S,want", [
        (512, 2048, (1, 2048)),   # the prefill chunk: 128 blocks a row
        (8, 2048, (8, 256)),      # a short chunk: two 64-row tiles a row
        (1, 2048, (16, 128)),     # one token: one tile a row
        (64, 300, (1, 320)),      # 16 blocks a row: one range over S
    ])
    def test_wide_chunk_splits_take_64_row_blocks(self, T, S, want):
        """At D 576 a chunk block holds 64 query rows, and the plan
        follows (Hkv, G, T, S, D) alone."""
        assert tdec.chunk_rows(576) == 64 and tdec.chunk_rows(128) == 128
        assert tdec.chunk_splits(1, 16, T, S, 576) == want
        for B in (1, 3, 8):
            blocks, nsplit, cols, part = tmla.plan(B, 16, T, S, decode=False)
            assert (nsplit, cols) == want
            assert blocks == B * -(-16 * T // 64)
            assert part == (blocks * nsplit * 64 * 514 if nsplit > 1 else 0)

    def test_rmsnorm_without_grad_skips_the_autograd_function(
            self, monkeypatch):
        """Under torch.no_grad, or when neither input needs a gradient,
        ops.rmsnorm calls the kernel wrapper itself (on the CPU its plain
        version), not RMSNorm.apply; with a gradient wanted it takes the
        Function, so the backward is the kernel's."""
        rng = np.random.default_rng(6)
        _, x = pair(rng, 3, 5, 64)
        _, w = pair(rng, 64)
        want = tref.rmsnorm(x, w)
        calls = []
        real = trms.RMSNorm.apply

        def spy(*args):
            calls.append(args)
            return real(*args)
        monkeypatch.setattr(trms.RMSNorm, "apply", spy)
        with torch.no_grad():
            torch.testing.assert_close(tops.rmsnorm(x, w), want, rtol=0,
                                       atol=0)
        torch.testing.assert_close(tops.rmsnorm(x, w), want, rtol=0, atol=0)
        assert calls == []
        xg = x.clone().requires_grad_()
        y = tops.rmsnorm(xg, w)
        assert len(calls) == 1 and y.grad_fn is not None
        with torch.no_grad():
            tops.rmsnorm(xg, w)
        assert len(calls) == 1

    def test_wrappers_check_before_launching(self):
        """The CUDA path validates without a card: a CPU tensor never
        reaches it, and the checks name what is wrong."""
        with pytest.raises(ValueError, match="CUDA tensor"):
            trms.check_cuda(torch.zeros(2), "rmsnorm")
        with pytest.raises(ValueError, match="multiple of 8"):
            trms.check_vectors(12, torch.zeros(12, dtype=torch.bfloat16))
        assert tdec.HEAD_DIMS == (32, 64, 80, 128)


class TestRMSNormPlans:
    """The rmsnorm kernels' launch plans (shapes only, no card)."""

    @pytest.mark.parametrize("D,elem,vpt,want", [
        (2048, 2, 2, 128), (2048, 2, 8, 32), (2560, 2, 2, 160),
        (2560, 2, 8, 64), (64, 2, 2, 4), (40, 2, 8, 1), (8, 2, 2, 1),
        (2048, 4, 8, 64), (5120, 2, 4, 160), (5120, 2, 8, 96),
        (16384, 2, 8, 256)])
    def test_row_threads_hold_the_row(self, D, elem, vpt, want):
        tpr = trms.row_threads(D, elem, vpt)
        assert tpr == want
        nvec = D * elem // 16
        assert tpr * vpt >= nvec
        # a power of two up to a warp, whole warps above
        assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0

    def test_rows_wider_than_a_block_are_refused(self):
        with pytest.raises(ValueError, match="at most 16384"):
            trms.check_width(16392, torch.zeros(1, dtype=torch.bfloat16))
        trms.check_width(16384, torch.zeros(1, dtype=torch.bfloat16))

    @pytest.mark.parametrize("rows", [1, 7, 8, 300, 4096, 8192, 100003])
    @pytest.mark.parametrize("D,elem", [(2048, 2), (2560, 2), (64, 2),
                                        (40, 2), (2048, 4), (5120, 2),
                                        (16384, 2)])
    def test_forward_plan_covers_every_row_once(self, rows, D, elem):
        """The forward plan follows the width alone: whole warps a block,
        the row held by its threads, and ceil(rows / rows a block) blocks
        cover every row once; at a decode tick's widths each row gets a
        block of its own."""
        vpt, tpr, groups = trms.forward_plan(D, elem)
        assert vpt in trms.VPTS and tpr == trms.row_threads(D, elem, vpt)
        assert tpr * vpt >= D * elem // 16
        threads = tpr * groups
        assert threads % 32 == 0 and threads <= trms.MAX_THREADS
        blocks = -(-rows // groups)   # block b: rows [b*groups, +groups)
        assert blocks * groups >= rows > (blocks - 1) * groups
        if D * elem >= 64 * 16:
            assert groups == 1

    @pytest.mark.parametrize("rows", [1, 2, 131, 132, 133, 1000, 8192,
                                      100003])
    @pytest.mark.parametrize("D,elem", [(2048, 2), (2560, 2), (40, 2),
                                        (2048, 4), (5120, 2), (16384, 2)])
    def test_backward_plan_covers_every_row_once(self, rows, D, elem):
        """Block b takes rows [b*per, (b+1)*per), `groups` of them at a
        time: every row is visited exactly once, no block is empty, and
        the dw partials number at most one per SM."""
        sms = 132
        tpr, groups, per, nblk = trms.backward_plan(rows, D, elem, sms)
        assert tpr == trms.row_threads(D, elem, trms.BWD_VPT)
        assert tpr * trms.BWD_VPT >= D * elem // 16
        threads = tpr * groups
        assert threads % 32 == 0 and threads <= trms.MAX_THREADS
        assert 1 <= nblk <= min(sms, rows)
        # shared memory for the groups' dw at the end: at most 64 KB
        assert groups * D * 4 <= 64 * 1024
        seen = np.zeros(rows, dtype=int)
        steps = -(-per // groups)
        for b in range(nblk):
            lo, hi = b * per, min(rows, (b + 1) * per)
            assert lo < hi
            for st in range(steps):
                for g in range(groups):
                    row = lo + st * groups + g
                    if row < hi:
                        seen[row] += 1
        assert (seen == 1).all()
