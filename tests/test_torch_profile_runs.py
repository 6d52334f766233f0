"""Real serve and train run dirs through the port's profile CLI and the
reference CLI, on the CPU, in both directions of who wrote them: a smoke
serve (profile ring refreshed every 2 ticks) and a 2-step Trainer run
(a shard every step) through `repro_torch`, and the same through the
reference package, give equal `report`, `timeline` and `diagnose`
output (text and `--json`) and exit codes from both CLIs' `main(argv)`;
and the port's CLI as a `python -m` process where jax cannot be
imported prints what the reference's `main` prints.
"""

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
DATA = os.path.join(ROOT, "tests", "data")
CLI = {name: importlib.import_module(f"{name}.profile.__main__")
       for name in ("repro", "repro_torch")}


def run_main(name, argv):
    """(exit code, stdout, stderr) of one package's CLI main(argv), with
    the port's prog name spelled as the reference's."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = CLI[name].main(list(argv))
        except SystemExit as e:
            rc = e.code
    norm = lambda s: s.replace("repro_torch.profile", "repro.profile")  # noqa
    return rc, norm(out.getvalue()), norm(err.getvalue())


def tiny_cfg(getter):
    return dataclasses.replace(getter("tinyllama_1_1b"), n_layers=2,
                               vocab=256)


def port_runs(root):
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import ServeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.serving import ServingEngine

    cfg = tiny_cfg(get_smoke)
    model = build_model(cfg, device="cpu")
    engine = ServingEngine(model, model.init(0), ServeConfig(
        max_batch=2, max_seq_len=64, profile_dir=str(root / "port-serve"),
        profile_label="serve-0", profile_interval_ticks=2))
    submit_and_drain(engine)
    Trainer(model, TrainConfig(ckpt_interval=0),
            CheckpointManager(str(root / "port-ckpt")),
            profile_dir=str(root / "port-train"), profile_interval=1).run(
        0, SyntheticLMData(cfg, 2, 16), n_steps=2, resume=False)


def ref_runs(root):
    import jax

    from repro.ckpt.manager import CheckpointManager
    from repro.configs import get_smoke
    from repro.configs.base import ServeConfig, TrainConfig
    from repro.data.pipeline import SyntheticLMData
    from repro.models import build_model
    from repro.runtime.trainer import Trainer
    from repro.serving.engine import ServingEngine

    cfg = tiny_cfg(get_smoke)
    model = build_model(cfg, impl="ref")
    engine = ServingEngine(model, model.init(jax.random.key(0)), ServeConfig(
        max_batch=2, max_seq_len=64, profile_dir=str(root / "ref-serve"),
        profile_label="serve-0", profile_interval_ticks=2))
    submit_and_drain(engine)
    Trainer(model, TrainConfig(ckpt_interval=0),
            CheckpointManager(str(root / "ref-ckpt")),
            profile_dir=str(root / "ref-train"), profile_interval=1).run(
        jax.random.key(0), SyntheticLMData(cfg, 2, 16), n_steps=2,
        resume=False)


def submit_and_drain(engine):
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        engine.submit(rng.integers(0, 256, n).astype(np.int32), 4)
    engine.run_until_drained()


@pytest.fixture(scope="module")
def real_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("real-runs")
    port_runs(root)
    ref_runs(root)
    return root


REAL_ARGV = {
    "report_json": ["report", "{run}", "--json"],
    "report_text": ["report", "{run}", "--component", "app", "serve",
                    "runtime"],
    "timeline_json": ["timeline", "{run}", "--json"],
    "timeline_text": ["timeline", "{run}", "--field", "count"],
    "diagnose_json": ["diagnose", "{run}", "--json"],
    "diagnose_text": ["diagnose", "{run}"],
}


@pytest.mark.parametrize("argv", sorted(REAL_ARGV))
@pytest.mark.parametrize("run", ["port-serve", "port-train", "ref-serve",
                                 "ref-train"])
def test_real_runs_read_equal_through_both_clis(real_runs, run, argv):
    args = [a.format(run=str(real_runs / run)) for a in REAL_ARGV[argv]]
    ref, port = run_main("repro", args), run_main("repro_torch", args)
    assert port == ref
    assert ref[0] == 0, ref
    if "--json" in args:
        doc = json.loads(ref[1])
        if argv == "diagnose_json":
            assert doc["manifest"]["kind"] == run.split("-")[1]
            assert doc["graph"]["rings"] >= 1


# ------------------------------------------------ python -m entry points --
def nojax_env(tmp_path):
    """PYTHONPATH whose `jax` cannot be imported: a port process that
    reached for jax would fail."""
    fake = tmp_path / "nojax" / "jax"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('jax is not installed here')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path / "nojax"), SRC]))


def test_python_m_entry_points_without_jax(real_runs, tmp_path):
    """The port's CLI as a process where jax cannot be imported: the same
    stdout as the reference's main() on the same arguments."""
    env = nojax_env(tmp_path)
    for args in (["report", os.path.join(DATA, "ci_baseline.xfa.npz")],
                 ["diagnose", str(real_runs / "port-serve"), "--json"],
                 ["diagnose", str(real_runs / "ref-train")],
                 ["timeline", str(real_runs / "port-train"), "--json"]):
        port = subprocess.run([sys.executable, "-m", "repro_torch.profile",
                               *args], env=env, capture_output=True,
                              text=True, timeout=120)
        rc, out, _ = run_main("repro", args)
        assert port.returncode == rc == 0, port.stderr
        assert port.stdout == out
    usage = subprocess.run([sys.executable, "-m", "repro_torch.profile",
                            "diagnose", str(tmp_path), "--config", "x"],
                           env=env, capture_output=True, text=True,
                           timeout=120)
    assert usage.returncode == 2 and "--fleet" in usage.stderr
