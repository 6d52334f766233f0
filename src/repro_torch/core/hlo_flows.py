"""Collective flows — the L3 static layer of XFA, in the port.

The port's copy of `repro/core/hlo_flows.py`, with two sources of
flows:

  * `parse_collective_flows` reads XLA's optimized HLO text (what the
    reference reads from `compiled.as_text()`), as the reference does.
    One fault of the reference is not copied: in optimized HLO the
    operands of an op carry no inline types (`all-to-all(%a, %b)`), and
    the reference took an op's input bytes from the operand text, so it
    read 0 bytes (and 0 wire bytes) for every collective whose input
    bytes count.  Here each operand's bytes come from its definition line
    in the module (as `hlo_analysis.py`'s symbol table reads them), and
    from an inline type only where the module does not define it.
  * the port runs no XLA: every collective of a torch run goes through
    `repro_torch.parallel.mesh`, whose recorder appends one
    `CollectiveFlow` per call while it is armed (`mesh.recording()`).
    The component comes from the process-wide scope stack here
    (`component("moe")`, `scoped("attention")`), which model code enters
    where it registers its static costs, as the reference's
    `jax.named_scope` threads an op_name through lowering.  The stack is
    per process, not per thread: autograd runs a backward, and the
    recompute of a checkpointed layer, on its own threads (the
    collectives' autograd Functions take their component at forward time
    and enter it in their backward).

Outputs feed three consumers:
  * the component x component collective flow matrix (views.py),
  * the roofline collective term (wire bytes / link bandwidth),
  * redundancy detection for the perf loop (same tensor gathered twice).

Wire-byte model (ring algorithm over a group of n):
  all-gather       (n-1)/n x output_bytes   per participating device
  reduce-scatter   (n-1)/n x input_bytes
  all-reduce       2(n-1)/n x input_bytes   (reduce-scatter + all-gather)
  all-to-all       (n-1)/n x input_bytes
  collective-permute  input_bytes           (point-to-point)
  broadcast        input_bytes              (a kind the reference lacks:
                   a pipelined ring from the root, in which every
                   participant but the last forwards the whole buffer
                   once; 0 for a group of one)
"""

from __future__ import annotations

import functools
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "f8e5m2fnuz": 1, "f8e4m3fnuz": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

#: the collective ops of XLA's HLO (the parser's vocabulary); the
#: recorder adds torch.distributed's `broadcast`, which the parser must
#: not match: in HLO `broadcast` is a shape op
COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OPNAME_RE = re.compile(r'op_name="([^"]*)"')
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=(?:\[[0-9,]+\])+(T\(([0-9,]+)\))?")
_SOURCE_TARGET_RE = re.compile(r"source_target_pairs=\{")


def _shape_bytes(dtype: str, dims_str: str) -> int:
    n = 1
    if dims_str.strip():
        for d in dims_str.split(","):
            n *= int(d)
    return n * DTYPE_BYTES.get(dtype, 4)


def _parse_shapes(text: str) -> List[int]:
    """All tensor byte-sizes appearing in `text` (a fragment of an HLO line)."""
    return [_shape_bytes(m.group(1), m.group(2))
            for m in _SHAPE_RE.finditer(text)]


@dataclass
class CollectiveFlow:
    """One collective op in the compiled module (per-device view)."""

    kind: str
    hlo_name: str
    input_bytes: int        # per-device operand bytes
    output_bytes: int       # per-device result bytes
    group_size: int         # participants per replica group
    group_stride: int       # device-id stride inside a group (1 = innermost)
    op_name: str            # full op_name metadata path
    component: str          # resolved component (via known-component match)
    axis: str               # best-effort mesh-axis name

    @property
    def wire_bytes(self) -> float:
        """Bytes each participant puts on the interconnect (ring model)."""
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        f = (n - 1) / n
        if self.kind == "all-gather":
            return f * self.output_bytes
        if self.kind == "reduce-scatter":
            return f * self.input_bytes
        if self.kind == "all-reduce":
            return 2.0 * f * self.input_bytes
        if self.kind == "all-to-all":
            return f * self.input_bytes
        if self.kind in ("collective-permute", "broadcast"):
            return float(self.input_bytes)
        return float(self.input_bytes)


def _resolve_component(op_name: str, known: Sequence[str]) -> str:
    """Innermost known component mentioned in the op_name scope path."""
    segments = re.split(r"[/()]", op_name)
    for seg in reversed(segments):
        seg = seg.strip()
        for comp in known:
            if seg == comp or seg.startswith(comp + ".") or seg.startswith(comp + "["):
                return comp
    # fall back: substring match, innermost first
    for seg in reversed(segments):
        for comp in known:
            if comp in seg:
                return comp
    return "app"


def _resolve_axis(group_size: int, group_stride: int,
                  mesh_axes: Dict[str, int]) -> str:
    """Best-effort mesh-axis attribution from (size, stride).

    With mesh (pod, data, model) laid out row-major, device id =
    ((pod*D)+data)*M + model.  A group over `model` has stride 1; over
    `data` stride M; over `pod` stride D*M.  Size breaks ties first, stride
    second; combined-axis groups report 'axis0+axis1'.
    """
    names = list(mesh_axes.keys())
    sizes = list(mesh_axes.values())
    # stride of each axis in row-major device numbering
    strides = {}
    acc = 1
    for name in reversed(names):
        strides[name] = acc
        acc *= mesh_axes[name]
    total = acc
    candidates = [n for n in names if mesh_axes[n] == group_size]
    if len(candidates) == 1:
        return candidates[0]
    for n in candidates:
        if strides[n] == group_stride:
            return n
    # combined axes (e.g. pod+data gradient reduction)
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            size = 1
            for n in names[i:j]:
                size *= mesh_axes[n]
            if size == group_size and (j == len(names) or
                                       strides[names[j - 1]] == group_stride):
                return "+".join(names[i:j])
    if group_size == total:
        return "+".join(names)
    return candidates[0] if candidates else f"size{group_size}"


_DEF_RE = re.compile(r"^(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.+)$")
_OPERAND_NAME_RE = re.compile(r"%([\w\.\-]+)")


def _result_type(rhs: str) -> str:
    """The result type of a definition's right-hand side: the text before
    its op name (the first lowercase word followed by '(')."""
    m = re.search(r"\s([a-z][a-z0-9\-]*)\(", rhs)
    return rhs[: m.start()] if m else rhs


def _symbols(hlo_text: str) -> Dict[str, int]:
    """%name -> result bytes of every definition in the module (XLA
    names each instruction uniquely within a module)."""
    out: Dict[str, int] = {}
    for raw in hlo_text.splitlines():
        d = _DEF_RE.match(raw.strip())
        if d:
            out[d.group(1)] = sum(_parse_shapes(_result_type(d.group(2))))
    return out


def _split_operands(text: str) -> List[str]:
    """The operand list of an op split at its top-level commas."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return parts


def _operand_bytes(operand_part: str, symbols: Dict[str, int]) -> int:
    """Each operand's bytes from its definition in the module; from its
    inline type where the module does not define it."""
    total = 0
    for op in _split_operands(operand_part):
        names = _OPERAND_NAME_RE.findall(op)
        if names and names[-1] in symbols:
            total += symbols[names[-1]]
        else:
            total += sum(_parse_shapes(op))
    return total


def parse_collective_flows(hlo_text: str,
                           known_components: Sequence[str] = (),
                           mesh_axes: Optional[Dict[str, int]] = None,
                           ) -> List[CollectiveFlow]:
    """Scan optimized HLO text and extract every collective op."""
    flows: List[CollectiveFlow] = []
    mesh_axes = mesh_axes or {}
    symbols = _symbols(hlo_text)
    for raw in hlo_text.splitlines():
        line = raw.strip()
        if not line or "=" not in line:
            continue
        kind = None
        for k in COLLECTIVE_KINDS:
            # match op name (e.g. ' = bf16[..] all-gather(' or 'all-gather-start(')
            if re.search(rf"[\s)]({k})(-start)?\(", line):
                kind = k
                break
        if kind is None:
            continue
        if re.search(rf"{kind}-done", line.split("=")[1][:120]):
            continue  # async completion — counted at -start
        lhs, rhs = line.split("=", 1)
        hlo_name = lhs.strip().lstrip("%")
        # result shapes before the op name; operand shapes inside parens
        opn = re.search(rf"({kind})(-start)?\(", rhs)
        result_part = rhs[: opn.start()]
        rest = rhs[opn.end():]
        paren_depth = 1
        i = 0
        while i < len(rest) and paren_depth:
            if rest[i] == "(":
                paren_depth += 1
            elif rest[i] == ")":
                paren_depth -= 1
            i += 1
        operand_part = rest[: i - 1]
        attr_part = rest[i:]

        out_bytes = sum(_parse_shapes(result_part))
        in_bytes = _operand_bytes(operand_part, symbols)
        if kind == "all-gather" and "-start" in rhs[: opn.end()]:
            # all-gather-start result is a tuple (operand, result) — keep result
            shapes = _parse_shapes(result_part)
            if len(shapes) >= 2:
                out_bytes = shapes[-1]

        group_size, group_stride = 1, 1
        m = _GROUPS_IOTA_RE.search(attr_part) or _GROUPS_IOTA_RE.search(rhs)
        if m:
            n_groups, g_size = int(m.group(1)), int(m.group(2))
            group_size = g_size
            # no transpose => contiguous ids => stride 1; transposed => outer
            if m.group(3):
                group_stride = n_groups
            else:
                group_stride = 1
        else:
            m2 = _GROUPS_EXPLICIT_RE.search(attr_part) or _GROUPS_EXPLICIT_RE.search(rhs)
            if m2:
                ids = [int(x) for x in m2.group(1).replace(" ", "").split(",") if x]
                group_size = len(ids)
                group_stride = (ids[1] - ids[0]) if len(ids) > 1 else 1
        if kind == "collective-permute":
            group_size = 2  # point-to-point; wire bytes = full operand

        opname_m = _OPNAME_RE.search(raw)
        op_name = opname_m.group(1) if opname_m else ""
        component = _resolve_component(op_name, known_components)
        axis = _resolve_axis(group_size, group_stride, mesh_axes) \
            if mesh_axes else f"size{group_size}"
        flows.append(CollectiveFlow(
            kind=kind, hlo_name=hlo_name, input_bytes=in_bytes,
            output_bytes=out_bytes, group_size=group_size,
            group_stride=group_stride, op_name=op_name,
            component=component, axis=axis))
    return flows


@dataclass
class CollectiveSummary:
    """Aggregated collective flows: per component, per kind, per axis."""

    flows: List[CollectiveFlow]
    by_component: Dict[str, float] = field(default_factory=dict)
    by_kind: Dict[str, float] = field(default_factory=dict)
    by_axis: Dict[str, float] = field(default_factory=dict)
    total_wire_bytes: float = 0.0

    @staticmethod
    def build(flows: List[CollectiveFlow]) -> "CollectiveSummary":
        s = CollectiveSummary(flows)
        for f in flows:
            wb = f.wire_bytes
            s.by_component[f.component] = s.by_component.get(f.component, 0.0) + wb
            s.by_kind[f.kind] = s.by_kind.get(f.kind, 0.0) + wb
            s.by_axis[f.axis] = s.by_axis.get(f.axis, 0.0) + wb
            s.total_wire_bytes += wb
        return s

    def schedule(self) -> List[Tuple[str, str, str, float]]:
        """(kind, component, axis, wire_bytes) in program order — the
        'collective schedule' recorded in EXPERIMENTS.md §Dry-run."""
        return [(f.kind, f.component, f.axis, f.wire_bytes) for f in self.flows]


def find_redundant_gathers(flows: List[CollectiveFlow]) -> List[Tuple[str, int]]:
    """Perf-loop helper: identical (kind, bytes, component, axis) collectives
    appearing more than once may indicate a re-gathered tensor (the paper's
    'same API invoked extensively' smell, XFA'd at the HLO level)."""
    seen: Dict[Tuple[str, int, str, str], int] = {}
    for f in flows:
        key = (f.kind, f.input_bytes, f.component, f.axis)
        seen[key] = seen.get(key, 0) + 1
    return [(f"{k[0]} {k[1]}B {k[2]}@{k[3]}", n)
            for k, n in sorted(seen.items()) if n > 1 and k[1] > 0]


# ------------------------------------------------------ component scopes ----
#: the process-wide stack of component scopes the recorder reads
_SCOPES: List[str] = []


class component:
    """`with component("moe"):` — collectives recorded inside resolve to
    the innermost scope (a list push and pop: cheap enough for every
    layer call)."""

    __slots__ = ("name",)

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        _SCOPES.append(self.name)

    def __exit__(self, *exc) -> None:
        _SCOPES.pop()


def scoped(name: str):
    """Decorator: run the function inside `component(name)`."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            _SCOPES.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _SCOPES.pop()
        return run
    return deco


def scope_path() -> str:
    """The open scopes, outermost first, as an op_name path."""
    return "/".join(_SCOPES)


def current_component() -> str:
    """The innermost open scope; "app" outside every scope (the
    reference's fallback)."""
    return _SCOPES[-1] if _SCOPES else "app"
