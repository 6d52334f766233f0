"""The port's multi-head latent attention (deepseek-v2-lite) against the
JAX package, on the CPU.

deepseek_v2_lite_16b's smoke config: 4 layers (one first-dense, three
MoE with 8 experts top 2 and 2 shared experts), d 128, 4 heads, latent
rank r 32, rope dim dr 16, nope dim dn 16, v dim 32: the latent path's
head dim is r + dr = 48, the expanded (training) path's dn + dr = 32.
The JAX params are flattened to numpy by the reference checkpoint naming
and loaded into the port; inputs are numpy draws from a seed.  Outputs,
logits, the loss and every gradient leaf agree at atol/rtol 1e-4 in f32
(the sides sum in different orders); routing, loads, drops, fold counts
and greedy tokens must be identical.  The D 576 plain attention versions
(deepseek's served head dim: r 512 + dr 64, 16 q heads over one latent kv
head, sm_scale (dn + dr) ** -0.5 = 192 ** -0.5) are held against the
Pallas kernels in interpret mode at a narrow batch and cache.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.kernels import ops as jops
from repro.models import build_model as jax_build
from repro.models import layers as jax_layers
from repro.runtime import trainer as jax_trainer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels import ops as tops
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as torch_layers
from repro_torch.models import train_state_from_numpy
from repro_torch.models import transformer as torch_transformer
from repro_torch.models.transformer import _layer
from repro_torch.runtime.trainer import Trainer, value_and_grad
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCH = "deepseek_v2_lite_16b"
ATOL = RTOL = 1e-4
DISPATCH = ("decoder", "moe", "dispatch")
ROUTER = ("decoder", "moe", "router")
#: the engines' pools: contiguous, and paged (12 pages of 8 rows)
SERVE = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=3,
             min_chunk_bucket=4, prefill_batch=4, page_size=8)
PROMPT_LENS = (3, 17, 5, 9)
MAX_NEW = (6, 5, 6, 4)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def both(remat="none", **kw):
    """(jax model, jax params, port model, port params), equal weights;
    `remat` is the port's policy (the reference's stays its own)."""
    jcfg = dataclasses.replace(jax_smoke(ARCH), **kw)
    tcfg = dataclasses.replace(torch_smoke(ARCH), remat=remat, **kw)
    jm = jax_build(jcfg, impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


@pytest.fixture(scope="module")
def ds():
    return both()


def folded(model, table):
    return model.fold_spec.fold(table)


def assert_folds_equal(got, want):
    """Two folded device tables: equal edges and counts, loads, drops
    and counts exactly, the router losses to the f32 tolerance."""
    assert got.edges.keys() == want.edges.keys()
    for key, w in want.edges.items():
        g = got.edges[key]
        assert g.count == w.count, key
        assert g.metrics.keys() == w.metrics.keys(), key
        for m, v in w.metrics.items():
            if key == ROUTER:
                np.testing.assert_allclose(g.metrics[m], v, rtol=RTOL,
                                           err_msg=m)
            else:
                assert g.metrics[m] == v, (key, m, g.metrics[m], v)


def batch_of(cfg, B=2, S=12, step=0):
    return JaxData(cfg, B, S, seed=3).generate(step)


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=what)


# ----------------------------------------------------------------- model ----
def test_build_model_takes_mla_with_the_reference_fold_spec(ds):
    """deepseek (moe with mla) builds; its fold spec holds the reference's
    slots in the reference's order and widths, and its caches the
    reference's latent layout, contiguous and paged."""
    jm, _, tm, _ = ds
    assert [(s.key, s.offset, s.width) for s in tm.fold_spec.slots()] == \
        [(s.key, s.offset, s.width) for s in jm.fold_spec.slots()]
    for jc, tc in ((jm.init_cache(2, 32), tm.init_cache(2, 32)),
                   (jm.init_paged_cache(12, 8), tm.init_paged_cache(12, 8))):
        assert sorted(tc) == sorted(jc) == ["ckv", "krope"]
        for name in jc:
            assert tuple(tc[name].shape) == jc[name].shape, name
            assert not tc[name].any()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_latent_branch_matches_reference(ds, paged, S):
    """mla_attention with a cache: the latent rows scattered at per-row
    offsets (in place), the absorbed queries through the decode (S 1) or
    chunk kernel's plain version, contiguous or through a block table:
    y and the updated latent cache equal the reference's."""
    jm, jp, tm, tp = ds
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    B = 2
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 13], np.int32)
    positions = pos[:, None] + np.arange(S, dtype=np.int32)[None, :]
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    rows = 12 if paged else B         # pages, or rows of the cache
    seq = 8 if paged else 32
    cache = {"ckv": rng.standard_normal((rows, seq, r)).astype(np.float32),
             "krope": rng.standard_normal((rows, seq, dr)).astype(np.float32)}
    bt = np.array([[3, 1, 5, 0], [2, 4, 6, 7]], np.int32) if paged else None
    jlp = jax.tree.map(lambda a: a[0], jp["stack_dense"]["stack"])
    jy, jc = jax_layers.mla_attention(
        jlp, jnp.asarray(x), jm.rt, jnp.asarray(positions),
        {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(pos),
        block_table=None if bt is None else jnp.asarray(bt))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    ty, tc2 = torch_layers.mla_attention(
        _layer(tp["stack_dense"]["stack"], 0), torch.from_numpy(x), tm.rt,
        torch.from_numpy(positions), tc, torch.from_numpy(pos),
        None if bt is None else torch.from_numpy(bt))
    close(ty.numpy(), jy, what="y")
    for name in ("ckv", "krope"):
        assert tc2[name] is tc[name]             # written in place
        close(tc[name].numpy(), jc[name], what=name)


def test_expanded_branch_matches_reference(ds):
    """mla_attention without a cache: the latent expanded into per-head
    K/V at head dim dn + dr, causal attention at sm_scale
    (dn + dr) ** -0.5."""
    jm, jp, tm, tp = ds
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, jm.cfg.d_model)).astype(np.float32)
    positions = np.arange(11, dtype=np.int32)
    jlp = jax.tree.map(lambda a: a[0], jp["stack_moe"]["stack"])
    jy, _ = jax_layers.mla_attention(jlp, jnp.asarray(x), jm.rt,
                                     jnp.asarray(positions))
    ty, cache = torch_layers.mla_attention(
        _layer(tp["stack_moe"]["stack"], 0), torch.from_numpy(x), tm.rt,
        torch.from_numpy(positions))
    assert cache is None
    close(ty.numpy(), jy)


# --------------------------------------------------------------- serving ----
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("width,pad_to", [(1, None), (3, None), (3, 4),
                                          (9, None)])
def test_forward_chunk_matches_jax(ds, paged, width, pad_to):
    """Logits and the fold table of every chunk at per-row offsets
    [0, 11], the bucket pad included, contiguous or through block tables
    over a page arena."""
    jm, jp, tm, tp = ds
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jm.cfg.vocab, (2, 9)).astype(np.int32)
    pos = np.array([0, 11], np.int32)
    if paged:
        jc, tc = jm.init_paged_cache(12, 8), tm.init_paged_cache(12, 8)
        bt = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    else:
        jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jt, tt = jm.table(), tm.table()
    for start in range(0, 9, width):
        seg = tokens[:, start:start + width]
        n = seg.shape[1]
        chunk = np.zeros((2, max(pad_to or n, n)), np.int32)
        chunk[:, :n] = seg
        valid = np.full((2,), n, np.int32)
        args = (jnp.asarray(pos),) + ((jnp.asarray(bt),) if paged else ())
        targs = (torch.from_numpy(pos),) + (
            (torch.from_numpy(bt),) if paged else ())
        jfn = jm.forward_chunk_paged if paged else jm.forward_chunk
        tfn = tm.forward_chunk_paged if paged else tm.forward_chunk
        jl, jc, jt = jfn(jp, jnp.asarray(chunk), jt, jc, *args,
                         valid=jnp.asarray(valid))
        tl, tc, tt = tfn(tp, torch.from_numpy(chunk), tt, tc, *targs,
                         valid=torch.from_numpy(valid))
        close(tl.numpy(), jl, what=f"chunk at {start}")
        pos = pos + n
    assert_folds_equal(folded(tm, tt), folded(jm, jt))


def test_latent_logits_match_the_expanded_forward(ds):
    """The absorbed latent path (prefill in chunks of 4, then one decode
    step) gives at each chunk's last position the logits the expanded
    training forward gives there over the whole prefix: the two branches
    compute the same attention.  Drop-free (capacity_factor 8), so the
    expert capacity does not depend on the call's width."""
    _, jp, _, _ = ds
    tm = build_model(dataclasses.replace(torch_smoke(ARCH),
                                         capacity_factor=8.0), device="cpu")
    tp = params_from_numpy(flat_np(jp), tm.cfg, "cpu")
    tokens = np.random.default_rng(6).integers(0, tm.cfg.vocab, (2, 13)) \
        .astype(np.int32)
    with torch.no_grad():
        hidden, _, _ = torch_transformer.forward(
            tp, torch.from_numpy(tokens), tm.rt, None)
        full = torch_layers.lm_head(tp, hidden, tm.rt)
        cache, pos = tm.init_cache(2, 32), 0
        for start in range(0, 13, 4):
            seg = tokens[:, start:start + 4]
            lg, cache, _ = tm.forward_chunk(
                tp, torch.from_numpy(seg), None, cache,
                torch.tensor([pos, pos], dtype=torch.int32))
            pos += seg.shape[1]
            close(lg.numpy(), full[:, pos - 1].numpy(),
                  what=f"prefix of {pos}")


def greedy(model, params, prompt, max_new, width, pad_to=None, to=None,
           paged=False):
    """Greedy tokens of `model` after feeding `prompt` in `width`-token
    chunks (bucket-padded to `pad_to`), then width-1 decode steps, on a
    contiguous cache or a page arena of 8-row pages; `to` makes the
    package's arrays from numpy."""
    table, pos = model.table(), 0
    if paged:
        cache = model.init_paged_cache(9, 8)
        extra = (to(np.arange(1, 9, dtype=np.int32)[None]),)
    else:
        cache, extra = model.init_cache(1, 64), ()
    step = model.forward_chunk_paged if paged else model.forward_chunk
    for start in range(0, len(prompt), width):
        seg = prompt[start:start + width]
        n = len(seg)
        padded = np.zeros((1, max(pad_to or n, n)), np.int32)
        padded[0, :n] = seg
        lg, cache, table = step(params, to(padded), table, cache,
                                to(np.array([pos], np.int32)), *extra,
                                valid=to(np.array([n], np.int32)))
        pos += n
    toks = [int(np.argmax(np.asarray(lg[0])))]
    while len(toks) < max_new:
        lg, cache, table = step(params, to(np.array([[toks[-1]]], np.int32)),
                                table, cache, to(np.array([pos], np.int32)),
                                *extra)
        toks.append(int(np.argmax(np.asarray(lg[0]))))
        pos += 1
    return toks


@pytest.mark.parametrize("paged", [False, True])
def test_forward_chunk_width_token_identity(paged):
    """Drop-free (capacity_factor 8): feeding a prompt at widths {1, 3,
    3 padded to 4, whole}, contiguous or paged, gives the port the greedy
    tokens the reference gives for the whole prompt."""
    jm, jp, tm, tp = both(capacity_factor=8.0)
    prompt = np.random.default_rng(5).integers(0, jm.cfg.vocab, 9) \
        .astype(np.int32)
    want = greedy(jm, jp, prompt, 5, len(prompt), to=jnp.asarray)
    for width, pad_to in ((1, None), (3, None), (3, 4), (9, None)):
        assert greedy(tm, tp, prompt, 5, width, pad_to, to=torch.from_numpy,
                      paged=paged) == want, (width, pad_to)


def staggered_run(engine, prompts):
    reqs = [engine.submit(prompts[0], MAX_NEW[0])]
    engine.step()
    engine.step()
    reqs.append(engine.submit(prompts[1], MAX_NEW[1]))
    reqs.append(engine.submit(prompts[2], MAX_NEW[2]))
    engine.step()
    reqs.append(engine.submit(prompts[3], MAX_NEW[3]))
    engine.run_until_drained()
    return reqs


@pytest.fixture(scope="module")
def reference_engine(ds):
    """The reference engine's staggered run, once for the file: its
    requests and its folded table (contiguous pool; its chunk programs
    warmed first, as the port's engine is)."""
    jm, jp, _, _ = ds
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, jm.cfg.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = JaxEngine(jm, jp, JaxServeConfig(**SERVE, max_cache_pages=0))
    eng.warm_chunk_programs()
    return prompts, staggered_run(eng, prompts), folded(jm, eng.table)


@pytest.mark.parametrize("pages", [0, 12])
def test_greedy_tokens_match_the_reference_engine(ds, reference_engine,
                                                  pages):
    """Staggered mixed-length requests: the port's engine, contiguous or
    paged (12 pages of 8 rows), gives the reference engine's greedy
    tokens; the contiguous engine's fold table (warm-up included) is the
    reference engine's, and every routed token is counted: the loads sum
    to top_k x the engine's forward tokens x the MoE layers, the count to
    its forward calls x the MoE layers."""
    _, _, tm, tp = ds
    prompts, want, want_fold = reference_engine
    eng = ServingEngine(tm, tp, ServeConfig(**SERVE, max_cache_pages=pages))
    assert eng.paged == bool(pages)
    if not pages:
        eng.warm_chunk_programs()
    got = staggered_run(eng, prompts)
    for g, w in zip(got, want):
        assert g.done and g.output == w.output, (g.output, w.output)
    fold = folded(tm, eng.table)
    if not pages:
        assert_folds_equal(fold, want_fold)
    L = tm.cfg.n_layers - tm.cfg.first_dense_layers
    assert fold.edges[DISPATCH].count == eng.forward_calls * L
    assert sum(v for k, v in fold.edges[DISPATCH].metrics.items()
               if k.startswith("expert_load")) == \
        tm.cfg.top_k * eng.forward_tokens * L
    if pages:
        assert eng.allocator.in_use == 0


# ---------------------------------------------------------- D 576 kernels ----
#: deepseek's served latent attention at a narrow batch and cache: 16 q
#: heads over one kv head of r + dr = 576, sm_scale (dn + dr) ** -0.5
WIDE = dict(Hq=16, D=576, scale=192 ** -0.5)


def wide_inputs(rng, B, S, T=None):
    shape_q = (B, WIDE["Hq"], WIDE["D"]) if T is None else \
        (B, WIDE["Hq"], T, WIDE["D"])
    q = rng.standard_normal(shape_q).astype(np.float32)
    k = rng.standard_normal((B, 1, S, WIDE["D"])).astype(np.float32)
    v = rng.standard_normal((B, 1, S, WIDE["D"])).astype(np.float32)
    v[..., 512:] = 0.0                      # the latent, zero-padded
    return q, k, v


def pages_of(rng, k, v, ps):
    """k, v [B, 1, S, D] as page arenas of ps-row pages behind one random
    block table (page 0 scratch, large finite garbage).  Returns
    (k_pages, v_pages, block_table)."""
    B, _, S, D = k.shape
    nb = S // ps
    perm = rng.permutation(B * nb).reshape(B, nb).astype(np.int32) + 1

    def arena(x):
        out = np.full((1 + B * nb, 1, ps, D), 1e4, np.float32)
        out[perm.reshape(-1)] = x.reshape(B, 1, nb, ps, D) \
            .transpose(0, 2, 1, 3, 4).reshape(B * nb, 1, ps, D)
        return out
    return arena(k), arena(v), perm


@pytest.mark.parametrize("paged", [False, True])
def test_wide_decode_plain_matches_pallas(paged):
    """Decode at D 576, G 16, Hkv 1, kv_len 0, 1, ragged and full: the
    port's plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(8)
    B, S = 3, 64
    q, k, v = wide_inputs(rng, B, S)
    lens = np.array([0, 37, 64], np.int32)
    if paged:
        kp, vp, perm = pages_of(rng, k, v, 16)
        got = tops.decode_attention_paged(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            block_table=torch.from_numpy(perm), kv_len=torch.from_numpy(lens),
            sm_scale=WIDE["scale"], impl="ref")
        want = jops.decode_attention_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            block_table=jnp.asarray(perm), kv_len=jnp.asarray(lens),
            sm_scale=WIDE["scale"], impl="pallas", interpret=True)
    else:
        got = tops.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            kv_len=torch.from_numpy(lens), sm_scale=WIDE["scale"],
            impl="ref")
        want = jops.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            kv_len=jnp.asarray(lens), sm_scale=WIDE["scale"],
            impl="pallas", interpret=True)
    close(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert np.all(got.numpy()[0] == 0)          # the empty row


@pytest.mark.parametrize("paged", [False, True])
def test_wide_chunk_plain_matches_pallas(paged):
    """Chunk attention at D 576, G 16, Hkv 1, T 8 at per-row offsets: the
    port's plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(9)
    B, S, T = 2, 64, 8
    q, k, v = wide_inputs(rng, B, S, T)
    pos = np.array([0, 50], np.int32)
    if paged:
        kp, vp, perm = pages_of(rng, k, v, 16)
        got = tops.chunk_attention_paged(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            block_table=torch.from_numpy(perm), pos=torch.from_numpy(pos),
            sm_scale=WIDE["scale"], impl="ref")
        want = jops.chunk_attention_paged(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            block_table=jnp.asarray(perm), pos=jnp.asarray(pos),
            sm_scale=WIDE["scale"], impl="pallas", interpret=True)
    else:
        got = tops.chunk_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            pos=torch.from_numpy(pos), sm_scale=WIDE["scale"], impl="ref")
        want = jops.chunk_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            pos=jnp.asarray(pos), sm_scale=WIDE["scale"], impl="pallas",
            interpret=True)
    close(got.numpy(), want, atol=2e-5, rtol=2e-5)


# -------------------------------------------------------------- training ----
@pytest.mark.parametrize("remat", ["none", "dots_saveable"])
def test_loss_and_grads_match_jax(remat):
    """The loss (aux included) and every gradient leaf of one loss_fn +
    backward through the expanded branch against jax.value_and_grad, and
    the fold table after it against the reference's."""
    jm, jp, tm, tp = both(remat)
    batch = batch_of(jm.cfg)
    batch["mask"][1, 5:] = 0.0
    (jl, (jmet, jt)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    loss, metrics, tt, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["aux_loss"]),
                               float(jmet["aux_loss"]), rtol=RTOL)
    want = flat_np(jg)
    got = leaves_with_path(grads)
    assert sorted(n for n, _ in got) == sorted(want)
    assert "stack_moe/stack/attn/wkv_b" in want
    for name, leaf in got:
        close(leaf.numpy(), want[name], what=name)
    assert_folds_equal(folded(tm, tt), folded(jm, jt))


def test_trainer_loss_curve_tracks_the_reference(ds, tmp_path):
    """Three AdamW steps of the port's Trainer from a carried train state
    against the reference's step function on the same batches: each
    step's loss to rtol 1e-4, the grad norm to 1e-3."""
    jm, _, tm, _ = ds
    steps = 3
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    state = train_state_from_numpy(flat_np(jstate), tm.cfg, "cpu")
    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    want = []
    for step in range(steps):
        batch = JaxData(jm.cfg, 4, 16).generate(step)
        jstate, jmet, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, jm.table())
        want.append(jmet)
    trainer = Trainer(tm, tcfg, CheckpointManager(str(tmp_path / "t")))
    trainer.run(0, SyntheticLMData(tm.cfg, 4, 16), steps, resume=False,
                state=state)
    assert [h["step"] for h in trainer.history] == list(range(steps))
    for got, jmet in zip(trainer.history, want):
        np.testing.assert_allclose(got["loss"], float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {got['step']}")
        np.testing.assert_allclose(got["grad_norm"], float(jmet["grad_norm"]),
                                   rtol=1e-3)


@pytest.mark.parametrize("what", ["loss_fn", "forward_chunk"])
def test_static_costs_match_one_jax_trace(ds, what):
    """One port loss_fn + backward, or one forward_chunk, registers the
    edges and totals of one JAX trace of the same call, the latent
    projections' mla_proj edge included."""
    jm, jp, tm, tp = ds
    batch = batch_of(jm.cfg)
    JAX_COSTS.reset()
    if what == "loss_fn":
        jax.value_and_grad(jm.loss_fn, has_aux=True)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    else:
        jax.jit(jm.forward_chunk).lower(
            jp, jnp.asarray(batch["tokens"][:, :5]), jm.table(),
            jm.init_cache(2, 32), jnp.asarray([0, 3], jnp.int32))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    if what == "loss_fn":
        value_and_grad(tm, tp, batch, tm.table())
    else:
        tm.forward_chunk(tp, torch.from_numpy(batch["tokens"][:, :5]),
                         tm.table(), tm.init_cache(2, 32),
                         torch.tensor([0, 3], dtype=torch.int32))
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert ("attention", "attention", "mla_proj") in got
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


# --------------------------------------------------------------- weights ----
def test_params_from_numpy_takes_the_mla_leaves(ds):
    """The reference's MLA leaves (stack_dense/stack/attn/{wq, wkv_a,
    wkv_b, wo} and stack_moe/stack/attn/*) load as they are; a missing,
    extra or misshapen leaf raises."""
    jm, jp, tm, tp = ds
    flat = flat_np(jp)
    for stack in ("stack_dense", "stack_moe"):
        for leaf in ("wq", "wkv_a", "wkv_b", "wo"):
            assert f"{stack}/stack/attn/{leaf}" in flat
        assert f"{stack}/stack/attn/wk" not in flat
    for name, leaf in leaves_with_path(tp):
        np.testing.assert_array_equal(leaf.numpy(), flat[name], name)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "stack_moe/stack/attn/wkv_b"}, tm.cfg,
                          "cpu")
    bad = flat["stack_dense/stack/attn/wkv_a"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(dict(flat, **{"stack_dense/stack/attn/wkv_a": bad}),
                          tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, **{"stack_moe/stack/attn/wk":
                                        np.zeros(1)}), tm.cfg, "cpu")


def test_port_init_follows_reference_mla_distributions(ds):
    """Seeded port init of the MLA leaves at the reference's shapes and
    scales (fan_in ** -0.5 from a weight's first dim: d for wq and
    wkv_a, r for wkv_b, nh dv for wo), a pure function of the seed."""
    _, jp, tm, _ = ds
    cfg = tm.cfg
    a, b = tm.init(3), tm.init(3)
    flat = flat_np(jp)
    for name, leaf in leaves_with_path(a):
        assert tuple(leaf.shape) == flat[name].shape, name
    attn = a["stack_moe"]["stack"]["attn"]
    assert torch.equal(attn["wkv_b"], b["stack_moe"]["stack"]["attn"]["wkv_b"])
    for leaf, fan_in in (("wq", cfg.d_model), ("wkv_a", cfg.d_model),
                         ("wkv_b", cfg.kv_lora_rank),
                         ("wo", cfg.n_heads * cfg.v_head_dim)):
        std = attn[leaf].std().item()
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, leaf
