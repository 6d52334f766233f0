"""The port's dense model against the JAX model, on the CPU, same weights.

The JAX model's params (`model.init(jax.random.key(0))`) are flattened to
numpy by the reference checkpoint naming and loaded into the port through
`params_from_numpy`; both sides then run `forward_chunk` on the same
tokens.  Logits must agree at atol = rtol = 1e-4 in f32 (the two sides
sum in different orders; 1e-4 is about 100x the f32 noise seen at these
sizes) at chunk widths {1, 3, 3 padded to 4, whole prompt} with mixed
per-row offsets.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manager import CheckpointManager, _flatten
from repro.configs import get_smoke as jax_smoke
from repro.core.device_fold import STATIC_COSTS as JAX_COSTS
from repro.models import build_model as jax_build
from repro.models.layers import update_cache_rows as jax_update_rows
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.device_fold import STATIC_COSTS
from repro_torch.launch.serve import load_params
from repro_torch.models import (build_model, load_reference_checkpoint,
                                params_from_numpy)
from repro_torch.models.layers import update_cache_rows

DENSE_ARCHS = ["tinyllama_1_1b", "qwen3_14b", "starcoder2_7b",
               "granite_20b"]


def tiny(getter, arch, **kw):
    return dataclasses.replace(getter(arch), n_layers=2, vocab=256, **kw)


def both(arch, **kw):
    """(jax model, jax params, port model, port params) on equal weights."""
    jm = jax_build(tiny(jax_smoke, arch, **kw), impl="ref")
    jp = jm.init(jax.random.key(0))
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(jp)[0]}
    tm = build_model(tiny(torch_smoke, arch, **kw), device="cpu")
    return jm, jp, tm, params_from_numpy(flat, tm.cfg, "cpu")


def np_cache(tree):
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("width,pad_to", [(1, None), (3, None), (3, 4),
                                          (9, None)])
def test_forward_chunk_matches_jax(arch, width, pad_to):
    jm, jp, tm, tp = both(arch)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (2, 9)).astype(np.int32)
    pos = np.array([0, 11], np.int32)          # mixed per-row depths
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
    # the written cache rows agree too (pad rows past the frontier aside)
    jn, tn = np_cache(jc), {k: v.numpy() for k, v in tc.items()}
    for k in ("k", "v"):
        for b, end in enumerate(pos):
            np.testing.assert_allclose(tn[k][:, b, :, :end],
                                       jn[k][:, b, :, :end],
                                       atol=1e-4, rtol=1e-4)


def test_prefill_and_decode_step_match_jax():
    jm, jp, tm, tp = both("tinyllama_1_1b")
    prompt = np.arange(1, 8, dtype=np.int32)[None]
    jl, jc, jt = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, jm.table(),
                            jm.init_cache(1, 16))
    tl, tc, tt = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)},
                            tm.table(), tm.init_cache(1, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    tok = np.array([5], np.int32)
    at = np.array([7], np.int32)
    jl, _, _ = jm.decode_step(jp, jnp.asarray(tok), jt, jc, jnp.asarray(at))
    tl, _, _ = tm.decode_step(tp, torch.from_numpy(tok), tt, tc,
                              torch.from_numpy(at))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("pos", [[6, 2], [0, 5], [9, 9]])
def test_update_cache_rows_clamps_like_dynamic_update_slice(pos):
    """An overrunning write (pos + T > S) starts at S - T in both
    packages; in range, rows land at [pos, pos + T)."""
    rng = np.random.default_rng(6)
    dst = rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
    src = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = np.asarray(jax_update_rows(jnp.asarray(dst), jnp.asarray(src),
                                      jnp.asarray(p), seq_axis=2))
    t = torch.from_numpy(dst.copy())
    got = update_cache_rows(t, torch.from_numpy(src), torch.from_numpy(p))
    assert got is t                      # in place: the port's donation
    np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("width", [1, 4])
def test_static_costs_match_one_jax_trace(width):
    """One port forward_chunk call registers the same STATIC_COSTS edges
    and totals as one JAX trace of the same call (the JAX scan body is
    traced once and scaled by L; the port's loop runs L times, unscaled)."""
    jm, jp, tm, tp = both("qwen3_14b")
    tokens = np.ones((2, width), np.int32)
    pos = np.array([0, 3], np.int32)
    JAX_COSTS.reset()
    jm.forward_chunk(jp, jnp.asarray(tokens), jm.table(), jm.init_cache(2, 16),
                     jnp.asarray(pos))
    want = {k: dict(v) for k, v in JAX_COSTS.costs.items()}
    STATIC_COSTS.reset()
    tm.forward_chunk(tp, torch.from_numpy(tokens), tm.table(),
                     tm.init_cache(2, 16), torch.from_numpy(pos))
    got = {k: dict(v) for k, v in STATIC_COSTS.costs.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    L = tm.cfg.n_layers
    norm = got[("app", "norm", "rmsnorm")]["count"]
    assert norm == 2 * L + 1 + 2 * L            # + q/k norms (qk_norm)


def test_bf16_checkpoint_round_trip(tmp_path):
    """A bf16 reference checkpoint (np.save writes bf16 leaves that plain
    numpy reads back as void |V2) loads bit-exactly, bare or as a train
    state under 'params/'."""
    jm = jax_build(tiny(jax_smoke, "tinyllama_1_1b",
                        param_dtype="bfloat16"), impl="ref")
    jp = jm.init(jax.random.key(1))
    CheckpointManager(str(tmp_path / "bare")).save(3, jp)
    CheckpointManager(str(tmp_path / "state")).save(7, {"params": jp,
                                                        "step": 7})
    flat = load_reference_checkpoint(str(tmp_path / "bare"))
    assert flat["embed/table"].dtype == torch.bfloat16
    tm = build_model(tiny(torch_smoke, "tinyllama_1_1b",
                          param_dtype="bfloat16"), device="cpu")
    for params in (params_from_numpy(flat, tm.cfg, "cpu"),
                   load_params(tm, str(tmp_path / "state"))):
        for name, leaf in _flatten(jp)[0]:
            t = params
            for part in name.split("/"):
                t = t[part]
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(leaf, np.float32), name)
    step_dir = os.path.join(str(tmp_path / "bare"), "step_00000003")
    assert load_reference_checkpoint(step_dir).keys() == flat.keys()


def test_params_from_numpy_is_strict():
    jm, jp, tm, _ = both("tinyllama_1_1b")
    flat = {name: np.asarray(leaf) for name, leaf in _flatten(jp)[0]}
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in flat.items()
                           if k != "lm_head/w"}, tm.cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(dict(flat, **{"embed/table": flat["embed/table"][:3]}),
                          tm.cfg, "cpu")
    with pytest.raises(KeyError, match="does not use"):
        params_from_numpy(dict(flat, extra=np.zeros(1)), tm.cfg, "cpu")


@pytest.mark.parametrize("arch", ["xlstm_1_3b", "seamless_m4t_large_v2"])
def test_ssm_and_audio_families_build_with_their_fold_slots(arch):
    """The last two families build (tests/test_torch_xlstm.py and
    tests/test_torch_encdec.py hold them to the reference); their fold
    spec holds the trainer's slot, as the reference's."""
    tm = build_model(torch_smoke(arch), device="cpu")
    jm = jax_build(jax_smoke(arch), impl="ref")
    assert [(s.key, s.offset, s.width) for s in tm.fold_spec.slots()] == \
        [(s.key, s.offset, s.width) for s in jm.fold_spec.slots()]
    table = tm.table()
    assert table.shape == (jm.fold_spec.size,) and not table.any()


def test_an_unknown_family_raises():
    cfg = dataclasses.replace(torch_smoke("tinyllama_1_1b"), family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        build_model(cfg, device="cpu")


def test_moe_family_builds_with_its_fold_slots():
    """phi3.5-moe (moe without mla) builds; its fold spec holds the MoE
    slots and the trainer's, in the reference's order and widths."""
    tm = build_model(torch_smoke("phi3_5_moe_42b"), device="cpu")
    jm = jax_build(jax_smoke("phi3_5_moe_42b"), impl="ref")
    assert [(s.key, s.offset, s.width) for s in tm.fold_spec.slots()] == \
        [(s.key, s.offset, s.width) for s in jm.fold_spec.slots()]
    table = tm.table()
    assert table.shape == (jm.fold_spec.size,) and not table.any()
    assert table.device == tm.device


def test_cuda_is_the_default_and_never_falls_back():
    """Without a card, an entry point that was not asked for the CPU
    raises instead of running there."""
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA path")
    cfg = tiny(torch_smoke, "tinyllama_1_1b")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(cfg, device=device)
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_port_init_follows_reference_distributions():
    """Seeded port init: the reference's scales (fan_in ** -0.5, embed
    1.0, norm scales 1) and a pure function of the seed."""
    tm = build_model(tiny(torch_smoke, "tinyllama_1_1b"), device="cpu")
    a, b = tm.init(3), tm.init(3)
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
    d = tm.cfg.d_model
    wq = a["stack"]["stack"]["attn"]["wq"]
    assert wq.shape[0] == tm.cfg.n_layers
    assert abs(wq.std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(a["embed"]["table"].std().item() - 1.0) < 0.05
    assert torch.all(a["stack"]["stack"]["norm1"]["scale"] == 1)
