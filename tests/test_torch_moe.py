"""The port's MoE family (phi3.5-moe) against the JAX package, on the CPU.

Two configurations of phi3.5-moe's smoke config (8 experts, top 2, d 128,
vocab 256): "phi3.5" (2 MoE layers, no shared experts, as published) and
"dense+shared" (one first-dense layer, then 2 MoE layers with one shared
expert), so that every code path of the reference's single-device MoE
runs.  The JAX params are flattened to numpy by the reference checkpoint
naming and loaded into the port; inputs are numpy draws from a seed.

Routing is compared before outputs: the top-k expert indices must be
equal.  Loads, dropped tokens and fold counts must be exactly equal;
outputs, router losses, the loss and every gradient leaf agree at atol
1e-5 / rtol 1e-4 in f32 (the sides sum in different orders).  Greedy
tokens through the serving engine, contiguous and paged, must be
identical to the reference engine's.  The forward_chunk width identity
runs drop-free (capacity_factor 8, as the reference's engine tests run
it): at other widths the capacity C, which follows the call's token
count, drops other tokens, in both packages alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager as JaxCkpt
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.models import moe as jax_moe
from repro.runtime import trainer as jax_trainer
from repro.serving import ServingEngine as JaxEngine
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe as torch_moe
from repro_torch.models import train_state_from_numpy
from repro_torch.models.transformer import _layer
from repro_torch.runtime.trainer import Trainer, value_and_grad
from repro_torch.serving import ServingEngine
from repro_torch.tree import leaves_with_path

ARCH = "phi3_5_moe_42b"
ATOL, RTOL = 1e-5, 1e-4
VARIANTS = {
    "phi3.5": dict(n_layers=2, vocab=256),
    "dense+shared": dict(n_layers=3, vocab=256, first_dense_layers=1,
                         n_shared_experts=1, d_ff=256),
}
DISPATCH = ("decoder", "moe", "dispatch")
ROUTER = ("decoder", "moe", "router")


def configs(variant, **kw):
    """(reference config, port config) of a variant."""
    over = dict(VARIANTS[variant], **kw)
    return (dataclasses.replace(jax_smoke(ARCH), **over),
            dataclasses.replace(torch_smoke(ARCH), **over))


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def both(variant, remat="none", **kw):
    """(jax model, jax params, port model, port params), equal weights;
    `remat` is the port's policy (the reference's stays its own)."""
    jcfg, tcfg = configs(variant, **kw)
    jm = jax_build(jcfg, impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(dataclasses.replace(tcfg, remat=remat), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


@pytest.fixture(scope="module")
def phi():
    return both("phi3.5")


def n_moe(cfg):
    return cfg.n_layers - cfg.first_dense_layers


def folded(model, table):
    """The host-side fold of either package's table."""
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


# ----------------------------------------------------------------- layer ----
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("B,S", [(2, 9), (8, 1)])
def test_moe_layer_matches_reference(variant, B, S):
    """Layer 0 of the MoE stack on the same x: the router's top-k
    indices, then y, the fold table and aux_total of the reference's
    moe() (the single-device path: `_moe_dense`, plus the shared expert),
    and load, dropped, aux and z of `_moe_dense` itself.  (2, 9) drops
    choices at C 5; (8, 1) is a decode tick's shape, C 4."""
    jm, jp, tm, tp = both(variant)
    cfg = jm.cfg
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["stack_moe"]["stack"])
    tlp = _layer(tp["stack_moe"]["stack"], 0)
    T = B * S
    x2 = x.reshape(T, -1)
    _, jidx, _, _ = jax_moe._router(jlp["moe"]["router"], jnp.asarray(x2),
                                    cfg)
    _, tidx, _, _, _ = torch_moe._router(tlp["moe"]["router"],
                                         torch.from_numpy(x2), tm.cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    jy, jt, jaux = jax_moe.moe(jlp, jnp.asarray(x), jm.rt, jm.table())
    ty, tt, taux = torch_moe.moe(tlp, torch.from_numpy(x), tm.rt, tm.table())
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL)
    assert_folds_equal(folded(tm, tt), folded(jm, jt))

    C = max(4, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    _, (load, dropped, aux, z) = jax_moe._moe_dense(jlp["moe"],
                                                    jnp.asarray(x2), cfg, C)
    edge = folded(tm, tt).edges
    assert [edge[DISPATCH].metrics[f"expert_load[{e}]"]
            for e in range(cfg.n_experts)] == np.asarray(load).tolist()
    assert edge[DISPATCH].metrics["dropped_tokens"] == float(dropped)
    np.testing.assert_allclose(edge[ROUTER].metrics["aux_loss"], float(aux),
                               rtol=RTOL)
    np.testing.assert_allclose(edge[ROUTER].metrics["z_loss"], float(z),
                               rtol=RTOL)
    if (B, S) == (2, 9):
        assert float(dropped) > 0           # the capacity binds here


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forced_drops_are_counted_as_the_reference_counts_them(variant):
    """capacity_factor 0.05 (tests/test_models.py's forced-drop case):
    one loss_fn drops choices, and the port's fold holds the reference's
    loads and drops exactly, the loss to the f32 tolerance."""
    jm, jp, tm, tp = both(variant, capacity_factor=0.05)
    batch = batch_of(jm.cfg, B=2, S=16)
    jl, (_, jt) = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jm.table())
    tl, (_, tt) = tm.loss_fn(tp, batch, tm.table())
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    got, want = folded(tm, tt), folded(jm, jt)
    assert_folds_equal(got, want)
    assert got.edges[DISPATCH].metrics["dropped_tokens"] > 0


# ------------------------------------------------------------- training ----
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("remat", ["none", "dots_saveable"])
def test_loss_grads_and_fold_match_jax(variant, remat):
    """The loss (aux included), every gradient leaf against
    jax.value_and_grad, and the fold table after one loss_fn + backward
    against the reference's: the recompute of a remat'd layer emits into
    a table nobody keeps, so nothing counts twice."""
    jm, jp, tm, tp = both(variant, remat)
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
    for name, leaf in got:
        np.testing.assert_allclose(leaf.numpy(), want[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    got_f, want_f = folded(tm, tt), folded(jm, jt)
    assert_folds_equal(got_f, want_f)
    T = batch["tokens"].size
    assert got_f.edges[DISPATCH].count == n_moe(tm.cfg)
    assert sum(v for k, v in got_f.edges[DISPATCH].metrics.items()
               if k.startswith("expert_load")) == \
        T * tm.cfg.top_k * n_moe(tm.cfg)


def test_remat_changes_memory_not_the_loss_or_the_fold():
    """none / full / dots_saveable on the MoE model: the same loss, the
    same gradient bits, the same fold table and the same static costs."""
    _, tcfg = configs("dense+shared")
    batch = batch_of(tcfg)
    params = build_model(tcfg, device="cpu").init(0)
    out = {}
    for remat in ("none", "full", "dots_saveable"):
        model = build_model(dataclasses.replace(tcfg, remat=remat),
                            device="cpu")
        STATIC_COSTS.reset()
        loss, _, table, grads = value_and_grad(model, params, batch,
                                               model.table())
        out[remat] = (loss, leaves_with_path(grads), table,
                      {k: dict(v) for k, v in STATIC_COSTS.costs.items()})
    l0, g0, t0, c0 = out["none"]
    for remat in ("full", "dots_saveable"):
        l1, g1, t1, c1 = out[remat]
        assert torch.equal(l0, l1), remat
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g0, g1)), remat
        assert torch.equal(t0, t1), remat
        assert c1 == c0, remat


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_fn_static_costs_match_one_jax_trace(variant):
    """One port loss_fn + backward registers the edges and totals of one
    JAX trace of value_and_grad, the MoE layer's expert_ffn (and
    shared_ffn) included."""
    jm, jp, tm, tp = both(variant)
    batch = batch_of(jm.cfg)
    JAX_COSTS.reset()
    jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, jm.table())
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    value_and_grad(tm, tp, batch, tm.table())
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert ("decoder", "moe", "expert_ffn") in got
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_and_device_group_track_the_reference_trainer(
        micro, tmp_path):
    """Four steps from a carried train state on the same batches: the
    reference Trainer's and the port Trainer's final metrics, and their
    folded device tables (train_step count, loads, drops exactly)."""
    steps = 4
    jm, _, tm, _ = both("phi3.5")
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    flat = flat_np(jstate)
    jt = jax_trainer.Trainer(jm, jcfg, JaxCkpt(str(tmp_path / "j")))
    _, jlast = jt.run(jax.random.key(0), JaxData(jm.cfg, 4, 16), steps,
                      resume=False, state=jstate)
    tt = Trainer(tm, tcfg, CheckpointManager(str(tmp_path / "t")))
    _, tlast = tt.run(0, SyntheticLMData(tm.cfg, 4, 16), steps, resume=False,
                      state=train_state_from_numpy(flat, tm.cfg, "cpu"))
    for k in ("loss", "aux_loss", "grad_norm", "lr", "tokens"):
        np.testing.assert_allclose(tlast[k], jlast[k], rtol=1e-3, err_msg=k)
    got, want = tt.session._device_fold, jt.session._device_fold
    assert_folds_equal(got, want)
    assert got.edges[("app", "loss", "train_step")].count == steps
    assert sum(v for k, v in got.edges[DISPATCH].metrics.items()
               if k.startswith("expert_load")) == \
        tm.cfg.top_k * 4 * 16 * n_moe(tm.cfg) * steps


# ---------------------------------------------------------------- serving ----
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("width,pad_to", [(1, None), (3, None), (3, 4),
                                          (9, None)])
def test_forward_chunk_matches_jax(variant, width, pad_to):
    """Logits and the fold table of every chunk at mixed per-row offsets,
    the bucket pad included (it is routed and takes capacity in both)."""
    jm, jp, tm, tp = both(variant)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.array([0, 11], np.int32)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    jt, tt = jm.table(), tm.table()
    for start in range(0, 9, width):
        seg = tokens[:, start:start + width]
        n = seg.shape[1]
        w = max(pad_to or n, n)
        chunk = np.zeros((2, w), np.int32)
        chunk[:, :n] = seg
        valid = np.full((2,), n, np.int32)
        jl, jc, jt = jm.forward_chunk(jp, jnp.asarray(chunk), jt, jc,
                                      jnp.asarray(pos), jnp.asarray(valid))
        tl, tc, tt = tm.forward_chunk(tp, torch.from_numpy(chunk), tt, tc,
                                      torch.from_numpy(pos),
                                      torch.from_numpy(valid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        pos = pos + n
    assert_folds_equal(folded(tm, tt), folded(jm, jt))


def greedy(model, params, prompt, max_new, width, pad_to=None, to=None):
    """Greedy tokens of `model` after feeding `prompt` in `width`-token
    chunks (bucket-padded to `pad_to`), then width-1 decode steps; `to`
    makes the package's arrays from numpy."""
    cache, table, pos = model.init_cache(1, 64), model.table(), 0
    for start in range(0, len(prompt), width):
        seg = prompt[start:start + width]
        n = len(seg)
        padded = np.zeros((1, max(pad_to or n, n)), np.int32)
        padded[0, :n] = seg
        lg, cache, table = model.forward_chunk(
            params, to(padded), table, cache, to(np.array([pos], np.int32)),
            to(np.array([n], np.int32)))
        pos += n
    toks = [int(np.argmax(np.asarray(lg[0])))]
    while len(toks) < max_new:
        lg, cache, table = model.decode_step(
            params, to(np.array([toks[-1]], np.int32)), table, cache,
            to(np.array([pos], np.int32)))
        toks.append(int(np.argmax(np.asarray(lg[0]))))
        pos += 1
    return toks


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_chunk_width_token_identity(variant):
    """Drop-free (capacity_factor 8): feeding a prompt at widths {1, 3,
    3 padded to 4, whole} gives the port the greedy tokens the reference
    gives for the whole prompt."""
    jm, jp, tm, tp = both(variant, capacity_factor=8.0)
    prompt = np.random.default_rng(5).integers(0, 256, 9).astype(np.int32)
    want = greedy(jm, jp, prompt, 5, len(prompt), to=jnp.asarray)
    for width, pad_to in ((1, None), (3, None), (3, 4), (9, None)):
        assert greedy(tm, tp, prompt, 5, width, pad_to,
                      to=torch.from_numpy) == want, (width, pad_to)


def staggered_run(engine, prompts, max_new):
    reqs = [engine.submit(prompts[0], max_new[0])]
    engine.step()
    engine.step()
    reqs.append(engine.submit(prompts[1], max_new[1]))
    reqs.append(engine.submit(prompts[2], max_new[2]))
    engine.step()
    reqs.append(engine.submit(prompts[3], max_new[3]))
    engine.run_until_drained()
    return reqs


@pytest.mark.parametrize("chunk", [64, 3])
@pytest.mark.parametrize("pages", [0, 12])
def test_greedy_tokens_and_engine_table_match_reference_engine(phi, chunk,
                                                               pages):
    """Staggered mixed-length requests: the port's engine, contiguous or
    paged, gives the reference engine's greedy tokens, and its fold table
    (carried through every prefill group and decode tick, and the
    contiguous warm-up) the reference engine's.  Every routed token is
    counted: the loads sum to top_k x the engine's forward tokens (pad
    rows included) x the MoE layers, and the count to its forward calls x
    the MoE layers.  The warm-up runs on the contiguous engines at chunk
    3; the paged warm-up is not compared: every row of it writes and
    reads scratch page 0, where the writes collide in no specified order
    in either package, and its router losses follow."""
    jm, jp, tm, tp = phi
    kw = dict(max_batch=4, max_seq_len=64, eos_token=-1, prefill_chunk=chunk,
              min_chunk_bucket=4, prefill_batch=4, page_size=8,
              max_cache_pages=pages)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (3, 17, 5, 9)]
    max_new = [6, 5, 6, 4]
    jeng = JaxEngine(jm, jp, JaxServeConfig(**kw))
    teng = ServingEngine(tm, tp, ServeConfig(**kw))
    assert teng.paged == bool(pages)
    if not pages and chunk == 3:        # 3 shapes; at 64, 15 JAX compiles
        for e in (jeng, teng):
            e.warm_chunk_programs()
    want = staggered_run(jeng, prompts, max_new)
    got = staggered_run(teng, prompts, max_new)
    for g, w in zip(got, want):
        assert g.done and g.output == w.output, (g.output, w.output)
    t_fold = folded(tm, teng.table)
    assert_folds_equal(t_fold, folded(jm, jeng.table))
    L = n_moe(tm.cfg)
    assert t_fold.edges[DISPATCH].count == teng.forward_calls * L
    assert sum(v for k, v in t_fold.edges[DISPATCH].metrics.items()
               if k.startswith("expert_load")) == \
        tm.cfg.top_k * teng.forward_tokens * L


# ---------------------------------------------------------------- weights ----
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_params_from_numpy_takes_the_moe_leaves(variant):
    """The reference's MoE leaves (stack_moe/stack/moe/*, shared/*,
    stack_dense/stack/*) load as they are; a missing, extra or misshapen
    leaf raises, as for the dense family."""
    jm, jp, tm, tp = both(variant)
    flat = flat_np(jp)
    assert any(n.startswith("stack_moe/stack/moe/w_gate") for n in flat)
    if variant == "dense+shared":
        assert "stack_moe/stack/moe/shared/w_down" in flat
        assert "stack_dense/stack/mlp/w_up" in flat
    for name, leaf in leaves_with_path(tp):
        np.testing.assert_array_equal(leaf.numpy(), flat[name], name)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "stack_moe/stack/moe/router"}, tm.cfg,
                          "cpu")
    bad = flat["stack_moe/stack/moe/w_up"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(dict(flat, **{"stack_moe/stack/moe/w_up": bad}),
                          tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, **{"stack/stack/mlp/w_up": np.zeros(1)}),
                          tm.cfg, "cpu")


@pytest.mark.parametrize("sliced", [False, True])
def test_port_init_follows_reference_moe_distributions(sliced, monkeypatch):
    """Seeded port init of the MoE leaves at the reference's scales: the
    router at d ** -0.5, the experts at E ** -0.5 (its `_init` takes
    fan_in from a weight's first dim), a pure function of the seed; also
    when every leaf is drawn slice by slice along its layer dim, as the
    full-size model's largest leaves are."""
    from repro_torch.models import transformer
    if sliced:
        monkeypatch.setattr(transformer, "SLICED_DRAW_BYTES", 0)
    _, tcfg = configs("dense+shared")
    tm = build_model(tcfg, device="cpu")
    a, b = tm.init(3), tm.init(3)
    m = a["stack_moe"]["stack"]["moe"]
    assert torch.equal(m["w_up"], b["stack_moe"]["stack"]["moe"]["w_up"])
    d, E = tcfg.d_model, tcfg.n_experts
    assert m["w_gate"].shape == (n_moe(tcfg), E, d, tcfg.moe_d_ff)
    assert abs(m["router"].std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(m["w_down"].std().item() - E ** -0.5) < 0.1 * E ** -0.5
    assert a["stack_dense"]["stack"]["mlp"]["w_up"].shape[0] == 1
