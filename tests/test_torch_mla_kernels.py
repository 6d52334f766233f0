"""MLA's latent attention entry points on the CPU: the plain versions that
read the latent cache (ckv, krope) as it lies, against the k/v route the
reference's mla_attention takes (k = [ckv | krope], v = ckv zero-padded,
then the first r output columns) and against the JAX package's Pallas
kernels in interpret mode on the same numpy inputs.

Shapes are deepseek-v2-lite's served latent attention at a narrow batch
and cache: 16 q heads over one latent kv head of r + dr = 512 + 64,
sm_scale (dn + dr) ** -0.5 = 192 ** -0.5.  Against the k/v route the
latent plain versions are bitwise equal (torch.equal); against Pallas
they agree to 2e-5 (f32; the sides sum in different orders).  The MLA
layer's cached branch goes through the latent dispatchers only, and gives
bitwise what the k/v route gives.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro_torch.configs import get_smoke
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.kernels import mla_attention as tmla
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models import layers as torch_layers
from repro_torch.models.transformer import _layer

R, DR, G = 512, 64, 16
SCALE = 192 ** -0.5
S = 640                     # a multiple of every page size below
PAGE_SIZES = (0, 5, 16, 64)  # 0: the contiguous cache


def latent_cache(rng, B, S):
    ckv = rng.standard_normal((B, S, R)).astype(np.float32)
    krope = rng.standard_normal((B, S, DR)).astype(np.float32)
    return torch.from_numpy(ckv), torch.from_numpy(krope)


def kv_form(ckv, krope):
    """The reference's k/v form: [.., 1, S, r + dr] each."""
    return (torch.cat([ckv, krope], dim=-1)[:, None],
            F.pad(ckv, (0, krope.shape[-1]))[:, None])


def arenas(rng, ckv, krope, ps, limits):
    """The dense caches as two page arenas of ps-row pages behind one
    block table, a random permutation of pages 1..; slots past each row's
    limit point at scratch page 0, which holds large finite garbage in
    both arenas.  Returns (ckv_pages, krope_pages, block_table)."""
    B, S, _ = ckv.shape
    nb = S // ps
    perm = torch.from_numpy(
        rng.permutation(B * nb).reshape(B, nb).astype(np.int32) + 1)

    def arena(x, fill):
        out = torch.full((1 + B * nb, ps, x.shape[-1]), fill)
        out[perm.reshape(-1).long()] = x.reshape(B * nb, ps, x.shape[-1])
        return out
    bt = perm.clone()
    for b, lim in enumerate(limits):
        bt[b, -(-lim // ps):] = 0
    return arena(ckv, 1e4), arena(krope, -1e4), bt


# ------------------------------------------------- plain vs the k/v route ----
@pytest.mark.parametrize("ps", PAGE_SIZES)
def test_latent_decode_plain_is_the_kv_route(ps):
    """Decode at kv_len 0, 1, ragged and full: the latent plain version
    (and its dispatcher) equals the k/v route bitwise, residuals too."""
    rng = np.random.default_rng(20 + ps)
    B = 4
    ckv, krope = latent_cache(rng, B, S)
    q = torch.from_numpy(rng.standard_normal((B, G, R + DR))
                         .astype(np.float32))
    kv_len = torch.tensor([0, 1, 333, S], dtype=torch.int32)
    if ps:
        cp, rp, bt = arenas(rng, ckv, krope, ps, kv_len.tolist())
        got = ref.decode_attention_latent_paged(
            q, cp, rp, block_table=bt, kv_len=kv_len, sm_scale=SCALE)
        k, v = kv_form(cp, rp)
        want = ref.decode_attention_paged(q, k, v, block_table=bt,
                                          kv_len=kv_len, sm_scale=SCALE)
        via = tops.decode_attention_latent_paged(
            q, cp, rp, block_table=bt, kv_len=kv_len, sm_scale=SCALE)
    else:
        got, (m, l) = ref.decode_attention_latent(
            q, ckv, krope, kv_len=kv_len, sm_scale=SCALE,
            return_residuals=True)
        k, v = kv_form(ckv, krope)
        want, (m_w, l_w) = ref.decode_attention(
            q, k, v, kv_len=kv_len, sm_scale=SCALE, return_residuals=True)
        assert torch.equal(m, m_w) and torch.equal(l, l_w)
        via = tops.decode_attention_latent(q, ckv, krope, kv_len=kv_len,
                                           sm_scale=SCALE)
    assert got.shape == (B, G, R)
    assert torch.equal(got, want[..., :R])
    assert torch.equal(via, got)
    assert torch.all(got[0] == 0)             # the empty row


@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("T", [1, 8, 67, 512])
def test_latent_chunk_plain_is_the_kv_route(T, ps):
    """Chunk attention at T 1, 8, 67 and 512 at per-row offsets: the
    latent plain version (and its dispatcher) equals the k/v route
    bitwise."""
    rng = np.random.default_rng(30 + T + ps)
    B = 2
    ckv, krope = latent_cache(rng, B, S)
    q = torch.from_numpy(rng.standard_normal((B, G, T, R + DR))
                         .astype(np.float32))
    pos = torch.tensor([0, S - T - 3], dtype=torch.int32)
    if ps:
        cp, rp, bt = arenas(rng, ckv, krope, ps,
                            [p + T for p in pos.tolist()])
        got = ref.chunk_attention_latent_paged(q, cp, rp, block_table=bt,
                                               pos=pos, sm_scale=SCALE)
        k, v = kv_form(cp, rp)
        want = ref.chunk_attention_paged(q, k, v, block_table=bt, pos=pos,
                                         sm_scale=SCALE)
        via = tops.chunk_attention_latent_paged(
            q, cp, rp, block_table=bt, pos=pos, sm_scale=SCALE)
    else:
        got = ref.chunk_attention_latent(q, ckv, krope, pos=pos,
                                         sm_scale=SCALE)
        k, v = kv_form(ckv, krope)
        want = ref.chunk_attention(q, k, v, pos=pos, sm_scale=SCALE)
        via = tops.chunk_attention_latent(q, ckv, krope, pos=pos,
                                          sm_scale=SCALE)
    assert got.shape == (B, G, T, R)
    assert torch.equal(got, want[..., :R])
    assert torch.equal(via, got)


# ------------------------------------------------------- plain vs Pallas ----
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("T", [None, 1, 8])   # None: decode
def test_latent_plain_matches_pallas(T, paged):
    """The latent plain versions against the Pallas kernels in interpret
    mode, which take the reference's k/v form and give all 576 columns:
    decode at kv_len 0, ragged and full, chunk at T 1 and 8 at per-row
    offsets; contiguous and paged (page size 16)."""
    rng = np.random.default_rng(40 + (T or 0) + paged)
    B, S_ = 3, 64
    ckv, krope = latent_cache(rng, B, S_)
    qshape = (B, G, R + DR) if T is None else (B, G, T, R + DR)
    q = rng.standard_normal(qshape).astype(np.float32)
    tq = torch.from_numpy(q)
    lens = np.array([0, 37, 64], np.int32)
    pos = np.array([0, 20, 64 - (T or 1)], np.int32)
    if paged:
        limits = lens if T is None else pos + T
        cp, rp, bt = arenas(rng, ckv, krope, 16, limits.tolist())
        k, v = (x.numpy() for x in kv_form(cp, rp))
        jb = jnp.asarray(bt.numpy())
        if T is None:
            got = tmla.decode_attention_latent_paged(
                tq, cp, rp, block_table=bt, kv_len=torch.from_numpy(lens),
                sm_scale=SCALE)
            want = jops.decode_attention_paged(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                block_table=jb, kv_len=jnp.asarray(lens), sm_scale=SCALE,
                impl="pallas", interpret=True)
        else:
            got = tmla.chunk_attention_latent_paged(
                tq, cp, rp, block_table=bt, pos=torch.from_numpy(pos),
                sm_scale=SCALE)
            want = jops.chunk_attention_paged(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                block_table=jb, pos=jnp.asarray(pos), sm_scale=SCALE,
                impl="pallas", interpret=True)
    else:
        k, v = (x.numpy() for x in kv_form(ckv, krope))
        if T is None:
            got = tmla.decode_attention_latent(
                tq, ckv, krope, kv_len=torch.from_numpy(lens),
                sm_scale=SCALE)
            want = jops.decode_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                kv_len=jnp.asarray(lens), sm_scale=SCALE, impl="pallas",
                interpret=True)
        else:
            got = tmla.chunk_attention_latent(
                tq, ckv, krope, pos=torch.from_numpy(pos), sm_scale=SCALE)
            want = jops.chunk_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                pos=jnp.asarray(pos), sm_scale=SCALE, impl="pallas",
                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :R],
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------- the dispatch ----
KINDS = ["decode", "chunk", "decode_paged", "chunk_paged"]


def call_both(kind, rng):
    """(latent dispatcher call, the generic k/v call it stands for) on the
    same small inputs, as thunks."""
    B, S_, T, ps = 2, 32, 5, 8
    ckv, krope = latent_cache(rng, B, S_)
    k, v = kv_form(ckv, krope)
    q1 = torch.from_numpy(rng.standard_normal((B, G, R + DR))
                          .astype(np.float32))
    qc = torch.from_numpy(rng.standard_normal((B, G, T, R + DR))
                          .astype(np.float32))
    lens = torch.tensor([3, 32], dtype=torch.int32)
    pos = torch.tensor([0, 20], dtype=torch.int32)
    cp, rp, bt = arenas(rng, ckv, krope, ps, [32, 32])
    kp, vp = kv_form(cp, rp)
    kw = dict(sm_scale=SCALE)
    return {
        "decode": (lambda: tops.decode_attention_latent(
            q1, ckv, krope, kv_len=lens, **kw),
            lambda: tops.decode_attention(q1, k, v, kv_len=lens, **kw)),
        "chunk": (lambda: tops.chunk_attention_latent(
            qc, ckv, krope, pos=pos, **kw),
            lambda: tops.chunk_attention(qc, k, v, pos=pos, **kw)),
        "decode_paged": (lambda: tops.decode_attention_latent_paged(
            q1, cp, rp, block_table=bt, kv_len=lens, **kw),
            lambda: tops.decode_attention_paged(
                q1, kp, vp, block_table=bt, kv_len=lens, **kw)),
        "chunk_paged": (lambda: tops.chunk_attention_latent_paged(
            qc, cp, rp, block_table=bt, pos=pos, **kw),
            lambda: tops.chunk_attention_paged(
                qc, kp, vp, block_table=bt, pos=pos, **kw)),
    }[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_latent_dispatch_registers_the_reference_cost(kind):
    """A latent dispatcher registers, under the same edge, the FLOPs and
    bytes the reference registers for the k/v call it stands for, and
    gives that call's first r columns."""
    latent, generic = call_both(kind, np.random.default_rng(50))
    costs = []
    outs = []
    for fn in (latent, generic):
        STATIC_COSTS.reset()
        outs.append(fn())
        costs.append({k: dict(v) for k, v in STATIC_COSTS.costs.items()})
    assert costs[0] == costs[1] and costs[0]
    assert torch.equal(outs[0], outs[1][..., :R])


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("width", [1, 5])
def test_mla_layer_reads_the_latent_cache_in_place(monkeypatch, paged, width):
    """mla_attention's cached branch calls the latent dispatchers, never
    the k/v ones (so on the card it builds no [.., 576] K or padded V),
    and gives bitwise what the reference's k/v route gives."""
    cfg = get_smoke("deepseek_v2_lite_16b")
    model = build_model(cfg, device="cpu")
    lp = _layer(model.init(0)["stack_dense"]["stack"], 0)
    rng = np.random.default_rng(60 + width + paged)
    B = 2
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    x = torch.from_numpy(rng.standard_normal((B, width, cfg.d_model))
                         .astype(np.float32))
    pos = torch.tensor([0, 13], dtype=torch.int32)
    positions = pos[:, None] + torch.arange(width)[None, :]
    rows, seq = (12, 8) if paged else (B, 32)
    cache = {"ckv": rng.standard_normal((rows, seq, r)).astype(np.float32),
             "krope": rng.standard_normal((rows, seq, dr)).astype(np.float32)}
    bt = torch.tensor([[3, 1, 5, 0], [2, 4, 6, 7]], dtype=torch.int32) \
        if paged else None

    def run():
        c = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        return torch_layers.mla_attention(lp, x, model.rt, positions, c, pos,
                                          bt)[0]

    called = []
    generic = ("decode_attention", "chunk_attention",
               "decode_attention_paged", "chunk_attention_paged")
    latent = {name: getattr(tops, name.replace("_attention",
                                               "_attention_latent"))
              for name in generic}
    for name in generic:
        def refuse(*a, name=name, **kw):
            raise AssertionError(f"mla_attention called ops.{name}")
        monkeypatch.setattr(tops, name, refuse)
    for name, fn in latent.items():
        def counted(*a, fn=fn, **kw):
            called.append(fn.__name__)
            return fn(*a, **kw)
        monkeypatch.setattr(tops, fn.__name__, counted)
    y = run()
    want = ("decode" if width == 1 else "chunk") + "_attention_latent" \
        + ("_paged" if paged else "")
    assert called == [want]

    # the reference's route: the k/v form through the generic dispatchers
    monkeypatch.undo()
    for name in generic:
        def kv_route(q, ckv, krope, *a, name=name, **kw):
            k, v = kv_form(ckv, krope)
            return getattr(tops, name)(q, k, v, *a, **kw)[..., :r]
        monkeypatch.setattr(tops, latent[name].__name__, kv_route)
    assert torch.equal(y, run())
