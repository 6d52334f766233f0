"""Architecture registry: one module per assigned arch, exact published dims.

Each module exports CONFIG (full config, dry-run only) and smoke() (reduced
same-family variant instantiable on CPU). get_config(name) / list_archs() are
the public API used by --arch flags across launch/, benchmarks/ and tests/.
"""
from importlib import import_module

from .base import (MeshConfig, ModelConfig, ServeConfig, ShapeConfig, SHAPES,
                   SMOKE_SHAPES, TrainConfig, reduced)

ARCHS = (
    "granite_20b",
    "starcoder2_7b",
    "qwen3_14b",
    "tinyllama_1_1b",
    "zamba2_2_7b",
    "deepseek_v2_lite_16b",
    "phi3_5_moe_42b",
    "xlstm_1_3b",
    "internvl2_1b",
    "seamless_m4t_large_v2",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def list_archs():
    return list(ARCHS)


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    mod = import_module(f"{__name__}.{mod_name}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_")
    mod = import_module(f"{__name__}.{mod_name}")
    return mod.smoke()
