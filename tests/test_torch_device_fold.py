"""The port's L2 device fold (`DeviceFoldSpec`) against the reference's,
on the CPU.

* The spec: the same declares give the same slot layout (keys, offsets,
  widths, size); the same emit sequences give equal tables and equal
  host folds (edges, metrics, counts: f32 adds of the same values in the
  same order, so exactly); every error case raises what the reference
  raises.
* The trainer: a dense (tinyllama smoke) and a hybrid (zamba2 smoke) run
  of 3 steps from a carried train state fold the same `device` group as
  the reference Trainer on the same steps, and the shard the port writes
  reads alike in the reference's profile package and the port's, the
  device edges included.
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

from repro.ckpt.manager import CheckpointManager as JaxCkpt
from repro.ckpt.manager import _flatten
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.device_fold import DeviceFoldSpec as JaxSpec
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import build_model as jax_build
from repro.profile import load_profile as jax_load_profile
from repro.runtime import trainer as jax_trainer
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import TrainConfig
from repro_torch.core.device_fold import DeviceFoldSpec
from repro_torch.core.session import XFASession
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models import build_model, train_state_from_numpy
from repro_torch.profile import load_profile
from repro_torch.runtime.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEP = ("app", "loss", "train_step")

#: declare sequences: (caller, component, api, metric, width)
LAYOUTS = {
    "dense": [("app", "loss", "train_step", "count", 1)],
    "phi3.5 moe": [("decoder", "moe", "dispatch", "expert_load", 16),
                   ("decoder", "moe", "dispatch", "dropped_tokens", 1),
                   ("decoder", "moe", "router", "aux_loss", 1),
                   ("decoder", "moe", "router", "z_loss", 1),
                   ("decoder", "moe", "dispatch", "count", 1),
                   ("app", "loss", "train_step", "count", 1)],
    "re-declared": [("a", "b", "c", "m", 3), ("a", "b", "c", "count", 1),
                    ("a", "b", "c", "m", 3), ("x", "y", "z", "v", 2)],
    "empty": [],
}


def specs(layout):
    """(reference spec, port spec), both declared from `layout`, frozen."""
    out = []
    for cls in (JaxSpec, DeviceFoldSpec):
        s = cls()
        for caller, comp, api, metric, width in LAYOUTS[layout]:
            s.declare(caller, comp, api, metric, width)
        out.append(s.freeze())
    return out


def assert_same_fold(got, want):
    assert got.group == want.group
    assert got.edges.keys() == want.edges.keys()
    for key, w in want.edges.items():
        g = got.edges[key]
        assert (g.count, g.kind, g.metrics) == (w.count, w.kind, w.metrics), \
            key


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_slot_layout_matches_reference(layout):
    js, ts = specs(layout)
    assert ts.size == js.size
    assert [(s.key, s.offset, s.width) for s in ts.slots()] == \
        [(s.key, s.offset, s.width) for s in js.slots()]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emit_sequences_fold_as_the_reference(seed):
    """A random sequence of emits (Python numbers, scalar and vector
    tensors) into the phi3.5 layout: equal tables, equal folds."""
    js, ts = specs("phi3.5 moe")
    rng = np.random.default_rng(seed)
    jt, tt = js.init_table(), ts.init_table("cpu")
    assert tt.dtype == torch.float32 and tt.shape == (js.size,)
    keys = [k for k in LAYOUTS["phi3.5 moe"]]
    for _ in range(40):
        caller, comp, api, metric, width = keys[rng.integers(len(keys))]
        kind = rng.integers(3)
        if metric in ("count", "dropped_tokens", "expert_load"):
            v = rng.integers(0, 50, width).astype(np.float32)
        else:
            v = rng.standard_normal(width).astype(np.float32)
        if kind == 0 and width == 1:
            jv, tv = float(v[0]), float(v[0])
        else:
            jv, tv = jnp.asarray(v), torch.from_numpy(v)
            if width == 1 and kind == 1:
                jv, tv = jv[0], tv[0]
        jt = js.emit(jt, caller, comp, api, metric, jv)
        tt = ts.emit(tt, caller, comp, api, metric, tv)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        ts.read(tt, "decoder", "moe", "dispatch", "expert_load").numpy(),
        np.asarray(js.read(jt, "decoder", "moe", "dispatch", "expert_load")))
    assert_same_fold(ts.fold(tt), js.fold(np.asarray(jt)))
    assert_same_fold(ts.fold(tt.numpy(), group="g"),
                     js.fold(np.asarray(jt), group="g"))


def _redeclare(s):
    s.declare("a", "b", "c", "m", 2)
    s.declare("a", "b", "c", "m", 3)


def _after_freeze(s):
    s.declare("a", "b", "c", "m", 1)
    s.freeze()
    s.declare("a", "b", "c", "n", 1)


def _undeclared(s, table):
    s.declare("a", "b", "c", "m", 1)
    s.freeze()
    s.emit(table(s), "a", "b", "c", "nope", 1.0)


def _wrong_width(s, table, value):
    s.declare("a", "b", "c", "m", 3)
    s.freeze()
    s.emit(table(s), "a", "b", "c", "m", value)


@pytest.mark.parametrize("case", ["redeclare", "after_freeze", "undeclared",
                                  "wrong_width", "wrong_width_scalar"])
def test_errors_match_reference(case):
    """Each misuse raises the reference's exception type, with its
    message."""
    tables = {JaxSpec: lambda s: s.init_table(),
              DeviceFoldSpec: lambda s: s.init_table("cpu")}
    vals = {JaxSpec: jnp.ones(2), DeviceFoldSpec: torch.ones(2)}
    msgs = []
    for cls in (JaxSpec, DeviceFoldSpec):
        s, table = cls(), tables[cls]
        run = {"redeclare": lambda: _redeclare(s),
               "after_freeze": lambda: _after_freeze(s),
               "undeclared": lambda: _undeclared(s, table),
               "wrong_width": lambda: _wrong_width(s, table, vals[cls]),
               "wrong_width_scalar": lambda: _wrong_width(s, table, 1.0)}
        with pytest.raises(Exception) as info:
            run[case]()
        msgs.append((type(info.value), str(info.value)))
    assert msgs[1] == msgs[0]


def test_emit_returns_a_new_table_and_keeps_no_gradient():
    """The port's emit leaves its input table as it was (a recompute
    that emits again changes nothing the caller keeps) and detaches the
    value: observability must not perturb training."""
    _, ts = specs("phi3.5 moe")
    t0 = ts.init_table("cpu")
    x = torch.ones(16, requires_grad=True)
    t1 = ts.emit(t0, "decoder", "moe", "dispatch", "expert_load", x * 2)
    assert torch.equal(t0, torch.zeros_like(t0))
    assert not t1.requires_grad and t1[:16].eq(2).all()
    t2 = ts.emit(t1, *TRAIN_STEP, "count", 1.0)
    assert ts.fold(t2).edges[TRAIN_STEP].count == 1


def test_session_merges_the_device_fold_into_report_and_shards(tmp_path):
    """init_device_table / finish_device on a real table: the fold joins
    report() and the shard that snapshot() writes, as the reference's
    session merges it."""
    _, ts = specs("phi3.5 moe")
    sess = XFASession(device_spec=ts)
    table = sess.init_device_table("cpu")
    table = ts.emit(table, "decoder", "moe", "dispatch", "dropped_tokens",
                    torch.tensor(7.0))
    table = ts.emit(table, *TRAIN_STEP, "count", 1.0)
    sess.finish_device(table)
    rep = sess.report().folded.edges
    assert rep[("decoder", "moe", "dispatch")].metrics["dropped_tokens"] == 7
    assert rep[TRAIN_STEP].count == 1
    path = sess.snapshot(str(tmp_path / "s.xfa.npz"))
    for load in (load_profile, jax_load_profile):
        edges = load(path).to_folded().edges
        assert edges[TRAIN_STEP].count == 1
        assert edges[("decoder", "moe", "dispatch")].metrics[
            "expert_load[3]"] == 0.0
    with pytest.raises(RuntimeError, match="no DeviceFoldSpec"):
        XFASession().init_device_table()


# ---------------------------------------------------------------- trainer ----
ARCHS = {"dense": "tinyllama_1_1b", "hybrid": "zamba2_2_7b"}


def tiny(getter, family):
    cfg = getter(ARCHS[family])
    if family == "dense":
        cfg = dataclasses.replace(cfg, n_layers=2, vocab=256)
    return cfg


@pytest.mark.parametrize("family", list(ARCHS))
def test_trainer_device_group_matches_reference(family, tmp_path):
    """Three steps of each Trainer from the same carried train state on
    the same batches: the same folded device group (one train_step count
    a step), and the port's final shard holds it, read alike by the
    reference's profile package and the port's."""
    steps = 3
    jm = jax_build(tiny(jax_smoke, family), impl="ref")
    tm = build_model(tiny(torch_smoke, family), device="cpu")
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=steps,
              ckpt_interval=0)
    jcfg, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_trainer.init_train_state(jm, jax.random.key(0), jcfg)
    flat = {n: np.asarray(v) for n, v in _flatten(jstate)[0]}
    jt = jax_trainer.Trainer(jm, jcfg, JaxCkpt(str(tmp_path / "jck")))
    jt.run(jax.random.key(0), JaxData(jm.cfg, 2, 16), steps, resume=False,
           state=jstate)
    prof = str(tmp_path / "prof")
    tt = Trainer(tm, tcfg, CheckpointManager(str(tmp_path / "tck")),
                 profile_dir=prof)
    assert tt.session.device_spec is tm.fold_spec
    tt.run(0, SyntheticLMData(tm.cfg, 2, 16), steps, resume=False,
           state=train_state_from_numpy(flat, tm.cfg, "cpu"))
    got, want = tt.session._device_fold, jt.session._device_fold
    assert_same_fold(got, want)
    assert got.group == "device" and got.edges[TRAIN_STEP].count == steps
    shards = [load(prof).to_folded() for load in (load_profile,
                                                  jax_load_profile)]
    for folded in shards:
        e = folded.edges[TRAIN_STEP]
        assert e.count == steps and e.metrics == {"count": float(steps)}
    assert {k: (e.count, e.total_ns, e.metrics)
            for k, e in shards[0].edges.items()} == \
        {k: (e.count, e.total_ns, e.metrics)
         for k, e in shards[1].edges.items()}


def test_report_cli_shows_the_device_group(tmp_path):
    """A smoke MoE train run through the port's launcher: both CLIs'
    `report --json` list the train_step edge with the run's step count
    and the MoE dispatch edge with every expert's load."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    prof = tmp_path / "prof"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "phi3_5_moe_42b", "--smoke", "--layers", "2", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-interval", "0", "--profile-dir",
         str(prof)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    for pkg in ("repro_torch.profile", "repro.profile"):
        rep = subprocess.run(
            [sys.executable, "-m", pkg, "report", str(prof), "--json"],
            env=env, cwd=tmp_path, capture_output=True, text=True,
            timeout=300)
        assert rep.returncode == 0, rep.stderr[-3000:]
        edges = {(e["caller"], e["component"], e["api"]): e
                 for e in json.loads(rep.stdout)["edges"]}
        assert edges[TRAIN_STEP]["count"] == 2, pkg
        loads = [v for k, v in edges[("decoder", "moe", "dispatch")]
                 ["metrics"].items() if k.startswith("expert_load")]
        assert len(loads) == 8 and sum(loads) == 2 * 2 * 16 * 2 * 2, pkg
