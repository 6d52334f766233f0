"""The port's enc-dec family (seamless-m4t-large-v2's wiring) against the
JAX package, on the CPU, same weights.

A tiny config at the published grouping: 2 encoder and 2 decoder layers,
d_model 128, 4 q over 4 kv heads (G 1, as seamless's 16 over 16) of head
dim 32, the smoke frontend of 64 features, an ungated MLP, sources of at
most 48 frames.  The JAX model (impl="ref": the plain paths its own CPU
tests run, so its decode attention needs no block multiple) is
initialised, flattened to numpy by the reference checkpoint naming and
loaded into the port through `params_from_numpy`.  Tolerances, f32:
logits and cache rows at atol = rtol = 1e-4 (the sides sum in different
orders; f32 noise at this size is ~1e-6); the loss and every gradient
leaf at atol 1e-5 / rtol 1e-4 and N-step loss curves at rtol 1e-4, as
the dense family's (tests/test_torch_training.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import _flatten
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.runtime import trainer as jax_trainer
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import encdec
from repro_torch.runtime.trainer import make_train_step, value_and_grad
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "seamless_m4t_large_v2"
ATOL, RTOL = 1e-5, 1e-4
LOGIT_TOL = 1e-4
SRC = 24                # source frames of the serving tests
MAX_LEN = 64            # decoder cache rows


def tiny(getter, **kw):
    """seamless's smoke wiring: 2 + 2 layers, d_model 128, G 1, 64 frame
    features, a 256-word vocabulary."""
    return dataclasses.replace(getter(ARCH), vocab=256, **kw)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's side runs many small ops (tiny layers): one intra-op
    thread, so that they do not contend with the other test workers'
    threads for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params), equal weights."""
    jm = jax_build(tiny(jax_smoke), impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tiny(get_smoke), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def jnp_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def close_tree(port, ref, atol=ATOL, rtol=RTOL):
    got = leaves_with_path(port)
    assert sorted(n for n, _ in got) == sorted(ref)
    for name, leaf in got:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   np.asarray(ref[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


def serve_batch(cfg, B, T, S=SRC, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
            "frames": rng.standard_normal(
                (B, S, cfg.frontend_dim)).astype(np.float32)}


def batch_of(cfg, B=2, S=32, step=0, seed=3):
    """A SyntheticLMData batch: tokens, labels, mask [B, S] and frames
    [B, S, frontend_dim]."""
    return JaxData(cfg, B, S, seed=seed).generate(step)


def both_prefill(models, batch, src=SRC):
    jm, jp, tm, tp = models
    B = len(batch["tokens"])
    jl, jc, jt = jm.prefill(jp, jnp_tree(batch), jm.table(),
                            jm.init_cache(B, MAX_LEN, src_len=src))
    tl, tc, tt = tm.prefill(tp, batch, tm.table(),
                            tm.init_cache(B, MAX_LEN, src_len=src))
    return (jl, jc, jt), (tl, tc, tt)


def test_tiny_config_runs_the_published_grouping():
    cfg = tiny(get_smoke)
    assert cfg.family == "audio" and cfg.enc_layers == cfg.dec_layers == 2
    assert cfg.n_heads == cfg.n_kv_heads and not cfg.mlp_gated
    full = build_model(get_config(ARCH), device="cpu").cfg
    assert full.n_heads == full.n_kv_heads == 16 and full.head_dim_ == 64
    assert (full.enc_layers, full.dec_layers) == (24, 24)


# ---------------------------------------------------------------- params ----
def test_param_names_and_shapes_match_the_reference(models):
    jm, jp, tm, tp = models
    want = {n: a.shape for n, a in flat_np(jp).items()}
    got = {n: tuple(t.shape) for n, t in leaves_with_path(tp)}
    assert got == want
    assert got["dec_stack/stack/cross/attn/wq"] == (2, 128, 128)
    init = dict(leaves_with_path(tm.init(0)))
    assert {n: tuple(t.shape) for n, t in init.items()} == want


def test_full_config_specs_match_the_reference():
    """seamless at its published widths: the port's spec tree has the
    reference's leaf names and shapes (from jax.eval_shape, nothing
    allocated), 1.633B parameters."""
    jm = jax_build(jax_config(ARCH), impl="ref")
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    want = {n: tuple(a.shape) for n, a in _flatten(shapes)[0]}
    got = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                got[path] = tuple(v[0])
    walk(encdec.param_specs(get_config(ARCH)))
    assert got == want
    assert got["frontend/w"] == (1024, 1024)
    total = sum(int(np.prod(s)) for s in got.values())
    cfg = get_config(ARCH)
    norms = (2 * cfg.enc_layers + 3 * cfg.dec_layers + 2) * cfg.d_model
    # the config's count leaves out the frontend projection and the norms
    assert total == cfg.n_params() + 1024 * 1024 + norms == 1633179648


def test_port_init_draws_like_the_reference():
    """Seeded draws, a pure function of the seed; frontend/w at std
    frontend_dim ** -0.5, the norms ones."""
    tm = build_model(tiny(get_smoke), device="cpu")
    a, b = tm.init(3), tm.init(3)
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(leaves_with_path(a), leaves_with_path(b)))
    w = a["frontend"]["w"]
    f = tm.cfg.frontend_dim
    assert abs(w.std().item() - f ** -0.5) < 0.1 * f ** -0.5
    assert torch.equal(a["dec_stack"]["stack"]["norm3"]["scale"],
                       torch.ones(2, 128))


def test_params_from_numpy_is_strict_for_the_enc_dec(models):
    jm, jp, tm, _ = models
    flat = flat_np(jp)
    for name in ("frontend/w", "enc_norm/scale",
                 "dec_stack/stack/cross/attn/wk"):
        with pytest.raises(KeyError, match=f"missing leaf '{name}'"):
            params_from_numpy({k: v for k, v in flat.items() if k != name},
                              tm.cfg, "cpu")
    with pytest.raises(ValueError, match="cross/attn/wo: shape"):
        bad = flat["dec_stack/stack/cross/attn/wo"][:1]
        params_from_numpy(dict(flat, **{"dec_stack/stack/cross/attn/wo":
                                        bad}), tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, extra=np.zeros(1)), tm.cfg, "cpu")


# --------------------------------------------------------------- serving ----
@pytest.mark.parametrize("B,T", [(1, 1), (2, 9), (3, 24)])
def test_prefill_with_frames_matches_jax(models, B, T):
    """Encode the frames, write the cross cache, bulk-prefill the prompt:
    the last token's logits, every self-attention cache row written and
    every layer's cross K/V of every row."""
    batch = serve_batch(models[2].cfg, B, T)
    (jl, jc, _), (tl, tc, _) = both_prefill(models, batch)
    close(tl.numpy(), jl)
    for k in ("k", "v"):
        close(tc[k][:, :, :, :T].numpy(), np.asarray(jc[k])[:, :, :, :T])
        assert not tc[k][:, :, :, T:].any()
    for k in ("xk", "xv"):
        assert tc[k].shape == (2, B, 4, SRC, 32)
        close(tc[k].numpy(), jc[k])


def test_prefill_then_decode_ticks_match_jax(models):
    """Three decode ticks after the prefill: the self-attention decodes at
    pos + 1, the cross-attention at kv_len = src_len for every row (the
    decoder cache is longer than the source)."""
    jm, jp, tm, tp = models
    B, T = 2, 7
    batch = serve_batch(tm.cfg, B, T, seed=2)
    (_, jc, jt), (_, tc, tt) = both_prefill(models, batch)
    tok = np.array([3, 250], np.int32)
    for i in range(3):
        at = np.full((B,), T + i, np.int32)
        jl, jc, jt = jm.decode_step(jp, jnp.asarray(tok), jt, jc,
                                    jnp.asarray(at))
        tl, tc, tt = tm.decode_step(tp, torch.from_numpy(tok), tt, tc,
                                    torch.from_numpy(at))
        close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


@pytest.mark.parametrize("padded", [False, True])
def test_continuation_without_frames_reads_the_cross_cache(models, padded):
    """A continuation chunk without frames at per-row offsets (bucket-
    padded to 16 under valid when `padded`): the logits equal the
    reference's, and the cross cache is read, not written."""
    jm, jp, tm, tp = models
    B = 2
    batch = serve_batch(tm.cfg, B, 8, seed=4)
    (_, jc, jt), (_, tc, tt) = both_prefill(models, batch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, (B, 16)).astype(np.int32)
    pos = np.array([8, 8], np.int32)
    valid = np.array([16, 11], np.int32) if padded else None
    if padded:
        toks[1, 11:] = 0
    xk, xv = tc["xk"].clone(), tc["xv"].clone()
    jl, _, _ = jm.forward_chunk(jp, jnp.asarray(toks), jt, jc,
                                jnp.asarray(pos),
                                None if valid is None else jnp.asarray(valid))
    tl, tc, _ = tm.forward_chunk(tp, toks, tt, tc, pos, valid)
    close(tl.numpy(), jl)
    assert torch.equal(tc["xk"], xk) and torch.equal(tc["xv"], xv)


@pytest.mark.parametrize("split", [(5,), (3, 9, 16), (16, 17)])
def test_prompt_whole_or_in_chunks_gives_the_same_tokens(models, split):
    """A prompt of 20 tokens prefilled whole, or as a first chunk with the
    frames and continuations without them (the last bucket-padded to 16
    under valid), then 6 greedy ticks: the same tokens, and the logits
    within 1e-4."""
    _, _, tm, tp = models
    B, S = 2, 20
    batch = serve_batch(tm.cfg, B, S, seed=6)

    def greedy(logits, cache, at):
        out = []
        for _ in range(6):
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
            logits, cache, _ = tm.decode_step(tp, tok, None, cache, at)
            at = at + 1
        return torch.stack(out, 1), logits

    lw, cw, _ = tm.prefill(tp, batch, None,
                           tm.init_cache(B, MAX_LEN, src_len=SRC))
    whole = greedy(lw, cw, torch.full((B,), S, dtype=torch.int32))
    cuts = [0] + [c for c in split if c < S] + [S]
    cache = tm.init_cache(B, MAX_LEN, src_len=SRC)
    for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
        toks = batch["tokens"][:, a:b]
        valid = None
        if b == S and b - a < 16 and i:
            valid = np.full((B,), b - a, np.int32)
            toks = np.pad(toks, ((0, 0), (0, 16 - (b - a))))
        lc, cache, _ = tm.forward_chunk(
            tp, toks, None, cache, np.full((B,), a, np.int32), valid,
            frames=batch["frames"] if i == 0 else None)
    close(lc.numpy(), lw.numpy())
    chunked = greedy(lc, cache, torch.full((B,), S, dtype=torch.int32))
    assert torch.equal(chunked[0], whole[0])
    close(chunked[1].numpy(), whole[1].numpy())


def test_a_row_alone_gives_its_tokens_in_the_batch(models):
    """Each row of a batch of 3 (frames, prompt, 4 greedy ticks) gives
    the same tokens served alone."""
    _, _, tm, tp = models
    batch = serve_batch(tm.cfg, 3, 10, seed=7)

    def run(rows):
        sub = {k: v[rows] for k, v in batch.items()}
        logits, cache, _ = tm.prefill(tp, sub, None, tm.init_cache(
            len(rows), MAX_LEN, src_len=SRC))
        out = []
        at = torch.full((len(rows),), 10, dtype=torch.int32)
        for _ in range(4):
            tok = torch.argmax(logits, -1).to(torch.int32)
            out.append(tok)
            logits, cache, _ = tm.decode_step(tp, tok, None, cache, at)
            at = at + 1
        return torch.stack(out, 1)
    together = run([0, 1, 2])
    for r in range(3):
        assert torch.equal(run([r])[0], together[r]), r


def test_frames_must_fit_the_cross_cache(models):
    _, _, tm, tp = models
    batch = serve_batch(tm.cfg, 1, 4, S=SRC + 1)
    with pytest.raises(ValueError, match="source rows"):
        tm.prefill(tp, batch, None, tm.init_cache(1, MAX_LEN, src_len=SRC))


def test_init_cache_layout():
    """Decoder K/V at max_len, cross K/V at src_len (max_len without),
    the batch on axis 1 of every leaf, in the compute dtype."""
    tm = build_model(tiny(get_smoke), device="cpu")
    c = tm.init_cache(3, MAX_LEN, src_len=SRC)
    assert c["k"].shape == c["v"].shape == (2, 3, 4, MAX_LEN, 32)
    assert c["xk"].shape == c["xv"].shape == (2, 3, 4, SRC, 32)
    assert tm.init_cache(3, MAX_LEN)["xk"].shape == (2, 3, 4, MAX_LEN, 32)
    assert tm.init_paged_cache is None and tm.forward_chunk_paged is None


@pytest.mark.parametrize("T", [1, 6])
def test_serving_static_costs_match_one_jax_trace(models, T):
    """One prefill with frames (T tokens) and one decode tick register
    the same STATIC_COSTS edges and totals as one JAX trace of each."""
    jm, jp, tm, tp = models
    batch = serve_batch(tm.cfg, 2, T)
    at = np.full((2,), T, np.int32)
    tok = np.array([1, 2], np.int32)
    JAX_COSTS.reset()
    _, jc, _ = jm.prefill(jp, jnp_tree(batch), jm.table(),
                          jm.init_cache(2, 32, src_len=SRC))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    JAX_COSTS.reset()
    jm.decode_step(jp, jnp.asarray(tok), jm.table(), jc, jnp.asarray(at))
    want_tick = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    _, tc, _ = tm.prefill(tp, batch, None, tm.init_cache(2, 32, src_len=SRC))
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    STATIC_COSTS.reset()
    tm.decode_step(tp, tok, None, tc, at)
    got_tick = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    for g, w in ((got, want), (got_tick, want_tick)):
        assert g.keys() == w.keys()
        for key in w:
            assert g[key] == pytest.approx(w[key], rel=1e-12), key


# -------------------------------------------------------------- training ----
def test_loss_and_grads_match_jax(models):
    """loss_fn with frames and every gradient leaf, frontend/w, the
    encoder's and the cross-attention's included; a masked tail counts
    nothing."""
    jm, jp, tm, tp = models
    batch = batch_of(jm.cfg)
    batch["mask"][1, 5:] = 0.0
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jnp_tree(batch), jm.table())
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]),
                               rtol=RTOL)
    assert float(metrics["tokens"]) == 37.0
    close_tree(grads, flat_np(jg))
    for name in ("frontend/w", "enc_stack/stack/attn/wk",
                 "dec_stack/stack/cross/attn/wv"):
        leaf = dict(leaves_with_path(grads))[name]
        assert float(leaf.abs().max()) > 0, name


def test_remat_changes_memory_not_the_loss(models):
    """none / full / dots_saveable over the encoder and decoder layers:
    the same loss, the same gradient bits, the same static costs."""
    _, _, tm, params = models
    batch = batch_of(tm.cfg)
    out = {}
    for remat in ("none", "full", "dots_saveable"):
        model = build_model(dataclasses.replace(tm.cfg, remat=remat),
                            device="cpu")
        STATIC_COSTS.reset()
        loss, _, _, grads = value_and_grad(model, params, batch, None)
        out[remat] = (loss, leaves_with_path(grads),
                      {k: dict(v) for k, v in STATIC_COSTS.costs.items()})
    l0, g0, c0 = out["none"]
    for remat in ("full", "dots_saveable"):
        l1, g1, c1 = out[remat]
        assert torch.equal(l0, l1), remat
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g0, g1)), remat
        assert c1 == c0, remat


def test_encoder_is_bidirectional_and_the_decoder_causal(models):
    """A change in the last frame moves the first encoder output; a
    change in the last token leaves the earlier decoder positions."""
    _, _, tm, tp = models
    batch = batch_of(tm.cfg, B=1, S=16)
    with torch.no_grad():
        enc = encdec.encode(tp, batch["frames"], tm.rt)
        frames = batch["frames"].copy()
        frames[0, -1] += 1.0
        assert not torch.allclose(encdec.encode(tp, frames, tm.rt)[0, 0],
                                  enc[0, 0])
        x, _ = encdec.decode_train(tp, batch["tokens"], enc, tm.rt, None)
        toks = batch["tokens"].copy()
        toks[0, -1] = (toks[0, -1] + 1) % tm.cfg.vocab
        y, _ = encdec.decode_train(tp, toks, enc, tm.rt, None)
    assert torch.equal(x[0, :-1], y[0, :-1])
    assert not torch.equal(x[0, -1], y[0, -1])


def test_loss_fn_static_costs_match_one_jax_trace(models):
    jm, jp, tm, tp = models
    batch = batch_of(jm.cfg)
    JAX_COSTS.reset()
    jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, jnp_tree(batch),
                                                 jm.table())
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    value_and_grad(tm, tp, batch, None)
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


def test_batch_spec_matches_jax(models):
    jm, _, tm, _ = models
    spec = tm.batch_spec(ShapeConfig("t", 64, 4, "train"))
    want = jm.batch_spec(JaxShape("t", 64, 4, "train"))
    assert spec.keys() == want.keys()
    for name, s in want.items():
        assert spec[name][0] == s.shape
        assert str(spec[name][1]).split(".")[-1] == str(s.dtype)
    assert spec["frames"][0] == (4, 64, tm.cfg.frontend_dim)


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 7, 1)])
def test_synthetic_batches_with_frames_identical(seed, step, shard):
    """SyntheticLMData draws seamless's tokens and frames as the
    reference's does, draw for draw."""
    cfg = get_config(ARCH)
    a = SyntheticLMData(cfg, 2, 48, seed=seed, shard=shard,
                        n_shards=2).generate(step)
    b = JaxData(jax_config(ARCH), 2, 48, seed=seed, shard=shard,
                n_shards=2).generate(step)
    assert a.keys() == b.keys() == {"tokens", "labels", "mask", "frames"}
    assert a["frames"].shape == (2, 48, 1024)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_tracks_the_reference_trainer(models, micro):
    """Four steps from a carried reference train state on the same
    batches (frames included; the microbatch split cuts them by rows):
    the per-step losses and grad norms, and the final params."""
    from repro_torch.models import train_state_from_numpy
    steps = 4
    jm, _, tm, _ = models
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    state = train_state_from_numpy(flat_np(jstate), tm.cfg, "cpu")
    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    for step in range(steps):
        batch = batch_of(jm.cfg, B=4, S=24, step=step)
        jstate, jmet, _ = jstep(jstate, jnp_tree(batch), jm.table())
        state, met, _ = tstep(state, batch, None)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=RTOL, err_msg=f"step {step}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-3)
    close_tree(state["params"], {n[len("params/"):]: v for n, v in
                                 flat_np(jstate).items()
                                 if n.startswith("params/")},
               atol=1e-3, rtol=1e-3)


def test_trainer_run_folds_its_steps(tmp_path):
    """The port's Trainer on SyntheticLMData with frames: finite losses,
    and its session's device group counts each step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.runtime.trainer import Trainer
    cfg = tiny(get_smoke)
    t = Trainer(build_model(cfg, device="cpu"), TrainConfig(ckpt_interval=0),
                CheckpointManager(str(tmp_path / "ck")))
    _, last = t.run(0, SyntheticLMData(cfg, 2, 16), 2, resume=False)
    assert np.isfinite(last["loss"]) and last["tokens"] == 2 * 16
    folded = t.session.folded_all()
    assert folded.edges[("app", "loss", "train_step")].count == 2


def test_train_launcher_runs_the_arch_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-interval", "0"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: {'loss'" in out.stdout
