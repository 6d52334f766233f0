"""Import hygiene of the PyTorch port: `repro_torch` and every module of it
load without jax and without anything of the reference package `repro`
(a subprocess, so this test's own imports cannot mask a leak), and no
source line of the port or of chip_smoke.py imports either."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                       r"from\s+(jax|repro)(\.|\s))", re.M)


def port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_neither_jax_nor_reference():
    mods = port_modules()
    assert "repro_torch.serving.engine" in mods and len(mods) > 30
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.')))\n"
            "print('LEAKED', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_source_line_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = []
    for f in files:
        for m in FORBIDDEN.finditer(f.read_text()):
            hits.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not hits, hits


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "from repro.configs import get_config", "import repro",
                "    from repro.core import tracer"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.kernels import ops",
               "from .configs import get_config", "# import jax"):
        assert not FORBIDDEN.search(ok), ok
