"""Parameter and state sharding: path pattern -> logical axes -> the
placement of each dim, as the reference's `parallel/sharding.py`.

Every parameter leaf is matched by exactly one rule (tests enforce
this).  Stacked layer leaves carry a leading layer axis, and None is
prepended for it (detected through the '/stack' marker in the path).
The rules are Megatron-style TP over 'model', batch DP over
('pod', 'data'), EP over 'model' for experts, and ZeRO-1 (optimizer
state over 'data', `_apply_fsdp`) as a transform on top of the base
placement.

Where the reference hands a PartitionSpec to XLA, the port holds each
rank's slice itself: `spec_tree` gives a tuple per leaf (None, a mesh
axis or a tuple of axes per dim: the entries of the reference's
PartitionSpec), `shard_tree` cuts full leaves to this rank's slices and
`gather_tree` puts them back together.  `layout_tree` is the layout the
port's eager tensor parallelism runs: `spec_tree`, with two kinds of
leaf placed otherwise, because the reference's contiguous splits are
ones only GSPMD can run (it re-shards afterwards):
- under MQA (one kv head) the attention's K/V projections stay whole on
  every model rank;
- the Mamba2 block's `in_proj` columns [z | x | B | C | dt] and
  `conv_w` channels [x | B | C] are split by ssm heads, a `Segmented`
  dim: each model rank holds the z, x and dt columns of its own heads
  and B and C whole (one group), in that order; its gated norm's scale
  stays whole (the block gathers y over 'model' before that norm);
- the mLSTM's `w_up` columns [x | z] are `Segmented` too, each segment
  split by heads, and its per-head `w_q/k/v` and the sLSTM's recurrent
  `r_*` ([.., H, p, p]) are split on the head dim, where the reference's
  rules split the first p dim (a contraction GSPMD re-shards).
`gather_leaf` rebuilds such a leaf in the reference's column order.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..tree import leaves_with_path, map_with_path
from . import mesh as mesh_lib
from .axes import get_rules

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Segmented:
    """The placement of a dim made of consecutive segments of `widths`:
    segment i is split over `axis` (each rank its own contiguous block
    of it) where `split[i]`, else held whole on every rank of `axis`.
    A rank's slice of the dim is its part of each segment, in order."""
    axis: str
    widths: Tuple[int, ...]
    split: Tuple[bool, ...]

    def parts(self, n: int) -> List[Tuple[int, int, bool]]:
        """(start, length, split) of each segment in a rank's slice, at
        `n` ranks on the axis."""
        out, at = [], 0
        for w, s in zip(self.widths, self.split):
            if s and w % n:
                raise ValueError(f"segment of {w} does not split {n} ways")
            length = w // n if s else w
            out.append((at, length, s))
            at += length
        return out

# (regex over 'a/b/c' param path, logical axes per trailing dim of the leaf)
# Leading scan axis handled separately. Order matters: first match wins.
RULES: List[Tuple[str, Tuple[Optional[str], ...]]] = [
    # embeddings / unembedding: vocab sharded over model axis
    (r".*/embed/table$", ("vocab", None)),
    (r".*/lm_head/w$", (None, "vocab")),
    # MLA projections (deepseek)
    (r".*/attn/wq$", (None, "model")),
    (r".*/attn/wkv_a$", (None, None)),
    (r".*/attn/wkv_b$", (None, "model")),
    # attention
    (r".*/attn/w[kv]$", (None, "model")),
    (r".*/attn/wo$", ("model", None)),
    (r".*/attn/(q_norm|k_norm)$", (None,)),
    # MoE expert stacks: EP over the model axis; d_ff per expert unsharded
    # (the expert dim and d_ff cannot both map to 'model')
    (r".*/moe/(w_gate|w_up)$", ("expert", None, None)),
    (r".*/moe/w_down$", ("expert", None, None)),
    (r".*/moe/router$", (None, None)),
    (r".*/moe/shared/(w_gate|w_up)$", (None, "model")),
    (r".*/moe/shared/w_down$", ("model", None)),
    # dense MLP
    (r".*/mlp/(w_gate|w_up)$", (None, "model")),
    (r".*/mlp/w_down$", ("model", None)),
    # mamba2
    (r".*/ssm/in_proj$", (None, "model")),
    (r".*/ssm/out_proj$", ("model", None)),
    (r".*/ssm/conv_w$", (None, "model")),
    (r".*/ssm/(a_log|dt_bias|d_skip)$", ("model",)),
    (r".*/ssm/norm$", ("model",)),
    # xlstm
    (r".*/mlstm/w_up$", (None, "model")),
    (r".*/mlstm/w_(q|k|v)$", ("model", None)),
    (r".*/mlstm/w_gates$", (None, None)),
    (r".*/mlstm/w_down$", ("model", None)),
    (r".*/mlstm/skip$", ("model",)),
    (r".*/slstm/w_(i|f|z|o)$", (None, "model")),
    (r".*/slstm/r_(i|f|z|o)$", ("model", None)),
    (r".*/slstm/(ffn_gate|ffn_up)$", (None, "model")),
    (r".*/slstm/ffn_down$", ("model", None)),
    # norms and other vectors/scalars: replicated
    (r".*/[\w]*norm[\w]*/scale$", (None,)),
    (r".*/bias$", (None,)),
    # frontend stubs project precomputed embeddings into d_model
    (r".*/frontend/w$", (None, "model")),
]

_COMPILED = [(re.compile(pat), axes) for pat, axes in RULES]


def logical_axes_for(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    stacked = "/stack/" in path
    base = path.replace("/stack/", "/")
    for rx, axes in _COMPILED:
        if rx.match(base):
            out: Tuple[Optional[str], ...] = axes
            if stacked:
                out = (None,) + tuple(axes)
            if len(out) < ndim:   # broadcast leading None (extra stack dims)
                out = (None,) * (ndim - len(out)) + tuple(out)
            if len(out) != ndim:
                raise ValueError(
                    f"rule for {path} gives {len(out)} axes, leaf has {ndim}")
            return out
    raise KeyError(f"no sharding rule matches param path: {path}")


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else {}


def _to_mesh_axes(logical: Tuple[Optional[str], ...], mesh,
                  shape: Optional[Sequence[int]] = None) -> Spec:
    """Translate logical axes to mesh axes, dropping any that do not EVENLY
    divide the dim (vocab 151655 or d_ff 2730 fall back to replicated)."""
    rules = get_rules()
    sizes = _sizes(mesh)
    parts = []
    for i, ax in enumerate(logical):
        if ax is None:
            parts.append(None)
            continue
        mapped = tuple(m for m in rules.get(ax, (ax,)) if m in sizes)
        if mapped and shape is not None:
            extent = math.prod(sizes.get(m, 1) for m in mapped)
            if extent == 0 or shape[i] % extent != 0:
                mapped = ()
        parts.append(None if not mapped else
                     (mapped[0] if len(mapped) == 1 else mapped))
    return tuple(parts)


def _apply_fsdp(spec: Spec, shape: Sequence[int], dsize: int) -> Spec:
    """The largest dim not already sharded that `dsize` divides also
    goes over 'data' (ZeRO-1's optimizer-state transform)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, -1
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % dsize == 0 and s > best:
            best, best_dim = s, i
    if best_dim >= 0:
        parts[best_dim] = "data"
    return tuple(parts)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def _base_spec(path: str, leaf, mesh) -> Spec:
    shape = _shape(leaf)
    return _to_mesh_axes(logical_axes_for("/" + path, len(shape)), mesh,
                         shape)


def spec_tree(params: Any, mesh, fsdp: bool = False) -> Any:
    """The placement of every leaf of `params` (anything with .shape, at
    full size), as the reference's PartitionSpec tree holds it.
    fsdp=True also puts the largest still-whole dim over 'data'."""
    dsize = _sizes(mesh).get("data", 1)

    def leaf_spec(path, leaf):
        spec = _base_spec(path, leaf, mesh)
        if fsdp and dsize > 1:
            spec = _apply_fsdp(spec, _shape(leaf), dsize)
        return spec

    return map_with_path(leaf_spec, params)


def validate_rules(params: Any) -> List[str]:
    """Param paths with no matching rule (tests assert [])."""
    bad = []
    for path, leaf in leaves_with_path(params):
        try:
            logical_axes_for("/" + path, len(_shape(leaf)))
        except KeyError:
            bad.append("/" + path)
    return bad


def _ssm_segments(cfg) -> dict:
    """The Mamba2 leaves' last dims as `Segmented` over 'model': in_proj
    [z | x | B | C | dt] and conv_w [x | B | C], split by ssm heads."""
    di, n, H = cfg.d_inner_, cfg.ssm_state, cfg.n_ssm_heads
    return {"in_proj": Segmented("model", (di, di, n, n, H),
                                 (True, True, False, False, True)),
            "conv_w": Segmented("model", (di, n, n), (True, False, False))}


def _xlstm_segments(cfg) -> dict:
    """The mLSTM's w_up [x | z] as `Segmented` over 'model', each of its
    two di-wide segments split by heads (di is head-major)."""
    di = int(cfg.d_model * cfg.mlstm_proj_factor)
    return {"w_up": Segmented("model", (di, di), (True, True))}


def layout_tree(params: Any, mesh, cfg, zero1: bool = False) -> Any:
    """The placements the port's eager parallelism holds `params` in:
    `spec_tree`, except that under MQA (one kv head) the K/V projections
    stay whole on every model rank, a hybrid's Mamba2 leaves are split
    by ssm heads (`_ssm_segments`; its gated norm's scale whole), and an
    xLSTM's blocks by heads (`_xlstm_segments`; the per-head matrices on
    their head dim).  Tensor parallelism splits heads whole, so a model
    axis that does not divide the q heads, the kv heads of a GQA model
    or the ssm heads raises.  zero1=True gives the optimizer state's
    placements (`_apply_fsdp` over 'data')."""
    sizes = _sizes(mesh)
    tp = sizes.get("model", 1)
    if tp > 1 and getattr(cfg, "n_heads", 0):
        if cfg.n_heads % tp:
            raise ValueError(f"tensor parallelism {tp} does not divide "
                             f"{cfg.name}'s {cfg.n_heads} q heads")
        if cfg.n_kv_heads > 1 and cfg.n_kv_heads % tp:
            raise ValueError(f"tensor parallelism {tp} does not divide "
                             f"{cfg.name}'s {cfg.n_kv_heads} kv heads")
    ssm = tp > 1 and cfg.family == "hybrid"
    if ssm and cfg.n_ssm_heads % tp:
        raise ValueError(f"tensor parallelism {tp} does not divide "
                         f"{cfg.name}'s {cfg.n_ssm_heads} ssm heads")
    xl = tp > 1 and cfg.family == "ssm"
    segments = (_ssm_segments(cfg) if ssm else
                _xlstm_segments(cfg) if xl else {})
    dsize = sizes.get("data", 1)
    mqa = tp > 1 and getattr(cfg, "n_kv_heads", 0) == 1

    def leaf_spec(path, leaf):
        spec = _base_spec(path, leaf, mesh)
        if mqa and re.search(r"/attn/w[kv]$", "/" + path):
            spec = (None,) * len(spec)
        m = re.search(r"/ssm/(in_proj|conv_w|norm)$", "/" + path)
        if ssm and m:
            # None for the norm's scale: whole on every rank
            spec = (None,) * (len(spec) - 1) + (segments.get(m.group(1)),)
        if xl and re.search(r"/mlstm/w_up$", "/" + path):
            spec = (None,) * (len(spec) - 1) + (segments["w_up"],)
        if xl and re.search(r"/(mlstm/w_[qkv]|slstm/r_[ifzo])$",
                            "/" + path):
            # [.., H, p, p]: by heads
            spec = (None,) * (len(spec) - 3) + ("model", None, None)
        if zero1 and dsize > 1:
            spec = _apply_fsdp(spec, _shape(leaf), dsize)
        return spec

    return map_with_path(leaf_spec, params)


# ------------------------------------------------------- rank slices ----
def split_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a leaf's placement splits it over (a `Segmented`
    dim's axis included: some of its columns are split)."""
    out: List[str] = []
    for p in spec:
        if isinstance(p, Segmented):
            out.append(p.axis)
        elif p is not None:
            out += [p] if isinstance(p, str) else list(p)
    return tuple(out)


def replicated_parts(spec: Spec, mesh) -> List[Tuple[int, int, int, int]]:
    """(dim, start, length, n) of each part of this rank's slice that all
    n > 1 ranks of a `Segmented` dim's axis hold whole: a sum over the
    axis counts such a part n times."""
    out = []
    for d, p in enumerate(spec):
        if isinstance(p, Segmented) and mesh.size(p.axis) > 1:
            n = mesh.size(p.axis)
            out += [(d, start, length, n)
                    for start, length, s in p.parts(n) if not s]
    return out


def _dim_slice(mesh, p, size: int) -> Tuple[int, int]:
    """(start, length) of this rank's part of a dim of `size` placed on p."""
    n = mesh.size(p)
    if size % n:
        raise ValueError(f"dim of {size} does not split {n} ways")
    length = size // n
    return mesh.coord(p) * length, length


def shard_leaf(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of a full leaf (a view where no dim is split)."""
    out = full
    for d, p in enumerate(spec):
        if isinstance(p, Segmented):
            n, i = mesh.size(p.axis), mesh.coord(p.axis)
            if n > 1:
                out = torch.cat([
                    part.narrow(d, i * (w // n), w // n) if s else part
                    for part, w, s in zip(out.split(list(p.widths), dim=d),
                                          p.widths, p.split)], dim=d)
        elif p is not None and mesh.size(p) > 1:
            start, length = _dim_slice(mesh, p, full.shape[d])
            out = out.narrow(d, start, length)
    return out.contiguous() if out is not full else out


def sub_slice(t: torch.Tensor, spec: Spec, finer: Spec, mesh
              ) -> torch.Tensor:
    """A VIEW of the part of `t` (this rank's slice under `spec`) that a
    finer placement `finer` gives this rank: narrowed on each dim that
    `finer` splits and `spec` does not."""
    for d, (p, q) in enumerate(zip(spec, finer)):
        if p is None and q is not None and mesh.size(q) > 1:
            start, length = _dim_slice(mesh, q, t.shape[d])
            t = t.narrow(d, start, length)
    return t


def gather_leaf(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's slice (each rank gets it); a
    `Segmented` dim in the reference's column order."""
    out = local
    for d, p in enumerate(spec):
        if isinstance(p, Segmented):
            n = mesh.size(p.axis)
            if n > 1:
                ranks = mesh_lib.all_gather(out, mesh, p.axis, dim=d).chunk(
                    n, dim=d)
                parts = p.parts(n)
                out = torch.cat([
                    torch.cat([r.narrow(d, start, length) for r in ranks],
                              dim=d) if s else
                    ranks[0].narrow(d, start, length)
                    for start, length, s in parts], dim=d)
            continue
        if p is None:
            continue
        for a in reversed((p,) if isinstance(p, str) else tuple(p)):
            # minor axes first: each gather joins contiguous blocks
            out = mesh_lib.all_gather(out, mesh, a, dim=d)
    return out


def shard_tree(params: Any, mesh, specs: Any) -> Any:
    """Full leaves -> this rank's slices under `specs`."""
    return map_with_path(lambda _, x, s: shard_leaf(x, s, mesh), params,
                         specs)


def gather_tree(tree: Any, mesh, specs: Any) -> Any:
    """This rank's slices -> full leaves (a collective: every rank of the
    mesh calls it with the same tree structure)."""
    return map_with_path(lambda _, x, s: gather_leaf(x, s, mesh), tree,
                         specs)


def global_shape(local_shape: Sequence[int], spec: Spec, mesh
                 ) -> Tuple[int, ...]:
    return tuple(sum(p.widths) if isinstance(p, Segmented) else
                 n * (mesh.size(p) if p is not None else 1)
                 for n, p in zip(local_shape, spec))


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of this rank's slice of a full leaf of `shape`."""
    return tuple(sum(length for _, length, _ in p.parts(mesh.size(p.axis)))
                 if isinstance(p, Segmented) else
                 n // (mesh.size(p) if p is not None else 1)
                 for n, p in zip(shape, spec))
