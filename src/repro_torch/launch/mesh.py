"""Meshes of the launchers and the card's roofline constants, the port
of the reference's `launch/mesh.py`.  Making a mesh needs the process
group (`parallel.mesh.init_distributed`); importing this module touches
no device state."""

from __future__ import annotations

from typing import Dict, Tuple

from ..parallel.mesh import Mesh
from ..parallel.mesh import make_mesh as _make_mesh

#: the mesh axes of a --mesh spec of 2 or 3 dims, as the reference's
#: training launcher names them
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """'DxM' or 'PxDxM' -> (shape, axes)."""
    shape = tuple(int(x) for x in spec.lower().split("x"))
    if len(shape) not in MESH_AXES or min(shape) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {spec!r}")
    return shape, MESH_AXES[len(shape)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    return _make_mesh(shape, axes)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


# NVIDIA H100 SXM5 (80 GB), per card, from NVIDIA's H100 Tensor Core GPU
# datasheet (SXM column): the roofline constants PERF.md and chip_smoke.py
# use
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor core
HBM_BW = 3.35e12               # B/s
#: fourth-generation NVLink: 900 GB/s a card to the other cards of its
#: host, both directions together (18 links of 50 GB/s)
NVLINK_BW = 900e9              # B/s
