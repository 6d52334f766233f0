"""The port's vlm family (internvl2-1b's wiring) against the JAX package,
on the CPU, same weights.

A tiny config at the published grouping: 14 q heads over 2 kv heads (G 7)
of head dim 16, 2 layers, 16 patches of 64 features, so the plain
attention runs at internvl2-1b's G.  The JAX model (impl="ref": the plain
paths its own CPU tests run) is initialised, flattened to numpy by the
reference checkpoint naming and loaded into the port through
`params_from_numpy`.  Tolerances, f32: logits at atol = rtol = 1e-4 (the
sides sum in different orders; f32 noise at this size is ~1e-6); the loss
and every gradient leaf at atol 1e-5 / rtol 1e-4, as the dense family's
(tests/test_torch_training.py); N-step loss curves at rtol 1e-4.
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
from repro_torch.models.transformer import param_specs
from repro_torch.runtime.trainer import make_train_step, value_and_grad
from repro_torch.tree import leaves_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "internvl2_1b"
ATOL, RTOL = 1e-5, 1e-4
LOGIT_TOL = 1e-4


def tiny(getter, **kw):
    """internvl2-1b's smoke wiring at its published grouping (14 q over
    2 kv heads), narrow: 2 layers, d_model 128, head dim 16, 16 patches."""
    return dataclasses.replace(getter(ARCH), n_layers=2, vocab=256,
                               n_heads=14, n_kv_heads=2, head_dim=16, **kw)


def flat_np(tree):
    return {name: np.asarray(leaf) for name, leaf in _flatten(tree)[0]}


def both(**kw):
    """(jax model, jax params, port model, port params), equal weights."""
    jm = jax_build(tiny(jax_smoke, **kw), impl="ref")
    jp = jm.init(jax.random.key(0))
    tm = build_model(tiny(get_smoke, **kw), device="cpu")
    return jm, jp, tm, params_from_numpy(flat_np(jp), tm.cfg, "cpu")


def batch_of(cfg, B=2, S=40, step=0, seed=3):
    """A SyntheticLMData batch: tokens, labels, mask [B, S - n_patches]
    and patches [B, n_patches, frontend_dim]."""
    return JaxData(cfg, B, S, seed=seed).generate(step)


def jnp_tree(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close_tree(port, ref, atol=ATOL, rtol=RTOL):
    got = leaves_with_path(port)
    assert sorted(n for n, _ in got) == sorted(ref)
    for name, leaf in got:
        np.testing.assert_allclose(leaf.detach().float().numpy(),
                                   np.asarray(ref[name], np.float32),
                                   atol=atol, rtol=rtol, err_msg=name)


def test_tiny_config_runs_the_published_grouping():
    cfg = tiny(get_smoke)
    assert cfg.family == "vlm"
    assert cfg.n_heads // cfg.n_kv_heads == 7
    full = build_model(get_config(ARCH), device="cpu").cfg
    assert full.n_heads // full.n_kv_heads == 7 and full.head_dim_ == 64


# ---------------------------------------------------------------- params ----
def test_param_names_and_shapes_match_the_reference():
    jm, jp, tm, tp = both()
    want = {n: a.shape for n, a in flat_np(jp).items()}
    got = {n: tuple(t.shape) for n, t in leaves_with_path(tp)}
    assert got == want
    assert got["frontend/w"] == (tm.cfg.frontend_dim, tm.cfg.d_model)
    init = dict(leaves_with_path(tm.init(0)))
    assert {n: tuple(t.shape) for n, t in init.items()} == want


def test_full_config_specs_match_the_reference():
    """internvl2-1b at its published widths: the port's spec tree has the
    reference's leaf names and shapes (from jax.eval_shape, nothing
    allocated), the patch projection included."""
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
    walk(param_specs(get_config(ARCH)))
    assert got == want
    assert got["frontend/w"] == (1024, 896)


def test_port_init_draws_the_frontend_like_the_reference():
    """frontend/w: a normal draw of std frontend_dim ** -0.5 (the
    reference's _init with fan_in = shape[0]), a pure function of the
    seed."""
    tm = build_model(tiny(get_smoke), device="cpu")
    a, b = tm.init(3), tm.init(3)
    w = a["frontend"]["w"]
    assert torch.equal(w, b["frontend"]["w"])
    f = tm.cfg.frontend_dim
    assert abs(w.std().item() - f ** -0.5) < 0.1 * f ** -0.5


def test_params_from_numpy_is_strict_about_the_frontend():
    jm, jp, tm, _ = both()
    flat = flat_np(jp)
    with pytest.raises(KeyError, match="missing leaf 'frontend/w'"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "frontend/w"}, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="frontend/w: shape"):
        params_from_numpy(dict(flat, **{"frontend/w": flat["frontend/w"].T}),
                          tm.cfg, "cpu")
    dense = build_model(dataclasses.replace(tm.cfg, family="dense"),
                        device="cpu")
    with pytest.raises(KeyError, match="does not use.*frontend/w"):
        params_from_numpy(flat, dense.cfg, "cpu")


# --------------------------------------------------------------- serving ----
def prefix_batch(cfg, B, T, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32),
            "patches": rng.standard_normal(
                (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)}


@pytest.mark.parametrize("B,T", [(1, 1), (2, 9), (3, 24)])
def test_prefill_with_patches_matches_jax(B, T):
    """Bulk prefill behind the projected patches: the last token's
    logits, and every cache row written (prefix and text)."""
    jm, jp, tm, tp = both()
    batch = prefix_batch(tm.cfg, B, T)
    jl, jc, _ = jm.prefill(jp, jnp_tree(batch), jm.table(),
                           jm.init_cache(B, 64))
    tl, tc, _ = tm.prefill(tp, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                           tm.table(), tm.init_cache(B, 64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    rows = tm.cfg.n_patches + T
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k][:, :, :, :rows].numpy(),
                                   np.asarray(jc[k])[:, :, :, :rows],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert not tc[k][:, :, :, rows:].any()


def test_prefill_then_decode_matches_jax():
    """A decode step after the prefix prefill, at the offset P + T."""
    jm, jp, tm, tp = both()
    B, T = 2, 7
    batch = prefix_batch(tm.cfg, B, T, seed=2)
    _, jc, jt = jm.prefill(jp, jnp_tree(batch), jm.table(),
                           jm.init_cache(B, 64))
    _, tc, tt = tm.prefill(tp, batch, tm.table(), tm.init_cache(B, 64))
    tok = np.array([3, 250], np.int32)
    at = np.full((B,), tm.cfg.n_patches + T, np.int32)
    jl, _, _ = jm.decode_step(jp, jnp.asarray(tok), jt, jc, jnp.asarray(at))
    tl, _, _ = tm.decode_step(tp, torch.from_numpy(tok), tt, tc,
                              torch.from_numpy(at))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def page_tables(B, pages_per_row, seed=4):
    """Per-row block tables over a shuffled arena (page 0 is scratch)."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(B * pages_per_row) + 1
    return ids.reshape(B, pages_per_row).astype(np.int32)


@pytest.mark.parametrize("page_size", [0, 4, 16])
def test_chunked_prefill_matches_bulk(page_size):
    """The port of the reference's multimodal chunked-prefill test
    (tests/test_models.py::test_multimodal_chunked_prefill_matches_bulk):
    the prefix rides the pos = 0 chunk with the first 10 tokens, the next
    14 follow bucket-padded to 16 under valid = 14 at offset P + 10.
    The continuation's logits equal bulk prefill's, and the reference's
    own continuation's, contiguous (page_size 0) and through a page arena
    with the prefix passed to forward_chunk_paged."""
    jm, jp, tm, tp = both()
    cfg, B, P = tm.cfg, 2, tm.cfg.n_patches
    batch = prefix_batch(cfg, B, 24, seed=5)
    bulk, _, _ = tm.prefill(tp, batch, tm.table(), tm.init_cache(B, 96))

    head = dict(batch, tokens=batch["tokens"][:, :10])
    padded = np.zeros((B, 16), np.int32)
    padded[:, :14] = batch["tokens"][:, 10:24]
    pos = np.full((B,), P + 10, np.int32)
    valid = np.full((B,), 14, np.int32)
    _, jc, jt = jm.prefill(jp, jnp_tree(head), jm.table(),
                           jm.init_cache(B, 96))
    jl, _, _ = jm.forward_chunk(jp, jnp.asarray(padded), jt, jc,
                                jnp.asarray(pos), jnp.asarray(valid))
    np.testing.assert_allclose(np.asarray(jl), bulk.numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    zero = torch.zeros(B, dtype=torch.int32)
    prefix = tm.project_patches(tp, batch["patches"])
    assert prefix.shape == (B, P, cfg.d_model)
    if page_size:
        nb = -(-96 // page_size)
        bt = torch.from_numpy(page_tables(B, nb))
        cache = tm.init_paged_cache(B * nb + 1, page_size)
        _, cache, table = tm.forward_chunk_paged(
            tp, head["tokens"], tm.table(), cache, zero, bt,
            prefix_embeds=prefix)
        tl, _, _ = tm.forward_chunk_paged(
            tp, torch.from_numpy(padded), table, cache,
            torch.from_numpy(pos), bt, valid=torch.from_numpy(valid))
    else:
        _, cache, table = tm.forward_chunk(tp, head["tokens"], tm.table(),
                                           tm.init_cache(B, 96), zero,
                                           prefix_embeds=prefix)
        tl, _, _ = tm.forward_chunk(tp, torch.from_numpy(padded), table,
                                    cache, torch.from_numpy(pos),
                                    torch.from_numpy(valid))
    np.testing.assert_allclose(tl.numpy(), bulk.numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


def test_paged_decode_after_the_prefix_equals_contiguous():
    """Prefix prefill and three decode ticks, contiguous and paged (page
    size 8): the same logits at every tick."""
    _, _, tm, tp = both()
    B, P = 2, tm.cfg.n_patches
    batch = prefix_batch(tm.cfg, B, 5, seed=6)
    prefix = tm.project_patches(tp, batch["patches"])
    zero = torch.zeros(B, dtype=torch.int32)
    bt = torch.from_numpy(page_tables(B, 8))
    dense = tm.init_cache(B, 64)
    paged = tm.init_paged_cache(B * 8 + 1, 8)
    ld, dense, _ = tm.forward_chunk(tp, batch["tokens"], None, dense, zero,
                                    prefix_embeds=prefix)
    lp, paged, _ = tm.forward_chunk_paged(tp, batch["tokens"], None, paged,
                                          zero, bt, prefix_embeds=prefix)
    np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=1e-6, rtol=1e-6)
    for i in range(3):
        tok = torch.argmax(ld, dim=-1).to(torch.int32)
        at = torch.full((B,), P + 5 + i, dtype=torch.int32)
        ld, dense, _ = tm.decode_step(tp, tok, None, dense, at)
        lp, paged, _ = tm.decode_step_paged(tp, tok, None, paged, at, bt)
        np.testing.assert_allclose(lp.numpy(), ld.numpy(), atol=1e-6,
                                   rtol=1e-6)


def test_prefill_static_costs_match_one_jax_trace():
    """One port prefill with patches registers the same STATIC_COSTS
    edges and totals as one JAX trace of it (the patch projection
    registers none on either side; the layers count the prefix rows)."""
    jm, jp, tm, tp = both()
    batch = prefix_batch(tm.cfg, 2, 4)
    JAX_COSTS.reset()
    jm.prefill(jp, jnp_tree(batch), jm.table(), jm.init_cache(2, 32))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    tm.prefill(tp, batch, tm.table(), tm.init_cache(2, 32))
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key


# -------------------------------------------------------------- training ----
def test_loss_and_grads_match_jax():
    """loss_fn with patches (the loss on the text positions only) and
    every gradient leaf, frontend/w included; a masked tail counts
    nothing."""
    jm, jp, tm, tp = both()
    batch = batch_of(jm.cfg)
    batch["mask"][1, 5:] = 0.0
    (jl, (jmet, _)), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(
        jp, jnp_tree(batch), jm.table())
    loss, metrics, _, grads = value_and_grad(tm, tp, batch, tm.table())
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    assert float(metrics["tokens"]) == float(jmet["tokens"]) == 29.0
    close_tree(grads, flat_np(jg))
    assert float(grads["frontend"]["w"].abs().max()) > 0


def test_loss_ignores_the_prefix_positions():
    """The logits at the prefix positions never reach the loss: labels
    are [B, S - P], and the loss equals the cross entropy of the text
    positions of the whole forward."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import cross_entropy, lm_head
    _, _, tm, tp = both()
    batch = batch_of(tm.cfg, B=1, S=24)
    assert batch["labels"].shape == (1, 24 - tm.cfg.n_patches)
    loss, _ = tm.loss_fn(tp, batch, None)
    prefix = tm.project_patches(tp, batch["patches"])
    x, _, _ = transformer.forward(tp, batch["tokens"], tm.rt, None, prefix)
    assert x.shape[1] == 24
    want = cross_entropy(lm_head(tp, x[:, tm.cfg.n_patches:], tm.rt),
                         torch.from_numpy(batch["labels"]))
    assert torch.equal(loss, want)


def test_loss_fn_static_costs_match_one_jax_trace():
    jm, jp, tm, tp = both()
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


def test_batch_spec_matches_jax():
    jm, _, tm, _ = both()
    spec = tm.batch_spec(ShapeConfig("t", 64, 4, "train"))
    want = jm.batch_spec(JaxShape("t", 64, 4, "train"))
    assert spec.keys() == want.keys()
    for name, s in want.items():
        assert spec[name][0] == s.shape
        assert str(spec[name][1]).split(".")[-1] == str(s.dtype)
    assert spec["tokens"][0] == (4, 64 - tm.cfg.n_patches)


@pytest.mark.parametrize("seed,step,shard", [(0, 0, 0), (3, 7, 1)])
def test_synthetic_batches_with_patches_identical(seed, step, shard):
    """SyntheticLMData draws the vlm's tokens and patches as the
    reference's does, draw for draw."""
    cfg = get_config(ARCH)
    a = SyntheticLMData(cfg, 2, 300, seed=seed, shard=shard,
                        n_shards=2).generate(step)
    b = JaxData(jax_config(ARCH), 2, 300, seed=seed, shard=shard,
                n_shards=2).generate(step)
    assert a.keys() == b.keys() == {"tokens", "labels", "mask", "patches"}
    assert a["patches"].shape == (2, 256, 1024)
    assert a["tokens"].shape == (2, 300 - 256)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("micro", [1, 2])
def test_loss_curve_tracks_the_reference_trainer(micro):
    """Five steps from a carried reference train state on the same
    batches (patches included; the microbatch split cuts them by rows
    like the tokens): the per-step losses and grad norms."""
    from repro_torch.models import train_state_from_numpy
    steps = 5
    jm, _, tm, _ = both()
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=steps,
              microbatches=micro, ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    state = train_state_from_numpy(flat_np(jstate), tm.cfg, "cpu")
    jstep = jax.jit(jax_trainer.make_train_step(jm, jcfg))
    tstep = make_train_step(tm, tcfg)
    for step in range(steps):
        batch = batch_of(jm.cfg, B=4, S=32, step=step)
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
    """The port's Trainer on SyntheticLMData with patches: finite losses,
    and its session's device group counts each step."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.runtime.trainer import Trainer
    cfg = tiny(get_smoke)
    t = Trainer(build_model(cfg, device="cpu"), TrainConfig(ckpt_interval=0),
                CheckpointManager(str(tmp_path / "ck")))
    _, last = t.run(0, SyntheticLMData(cfg, 2, 24), 2, resume=False)
    assert np.isfinite(last["loss"]) and last["tokens"] == 2 * 8
    folded = t.session.folded_all()
    assert folded.edges[("app", "loss", "train_step")].count == 2


@pytest.mark.parametrize("arch", [ARCH, "granite_20b"])
def test_train_launcher_runs_the_arch_on_the_cpu(arch, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq", "24", "--ckpt-dir", str(tmp_path / "ck"),
         "--ckpt-interval", "0"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "done: {'loss'" in out.stdout
