"""Parallelism of the port on torch.distributed: the process layer and
meshes (`mesh`), the logical-axis rules (`axes`), the sharding rules and
rank slices (`sharding`), Megatron tensor parallelism (`tp`),
context-parallel decode (`context`) and the GPipe building block
(`pipeline`)."""

from .axes import (axis_size, get_runtime_mesh, resolve_spec, runtime_mesh,
                   set_runtime_mesh, shard)
from .mesh import (Mesh, all_gather, all_reduce, broadcast,
                   collective_counts, init_distributed, make_mesh,
                   reset_collective_counts)
from .sharding import (gather_tree, layout_tree, logical_axes_for,
                       shard_tree, spec_tree, validate_rules)
