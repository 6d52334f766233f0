"""Run registry — metadata manifests + the cross-run query API.

Folded XFA profiles only surface *unknown* performance issues when many
runs and many points in time are comparable (PAPER.md §4.3; ScalAna's
cross-run scaling-loss detection makes the same point).  That needs an
index: every trainer / serving process registers its run by writing a
`manifest.json` into its run directory with structured metadata — config
name, model arch (family), mesh shape, jax version, snapshot schema
version, label, start time — plus free-form extras.  A registry root is
any directory tree containing run dirs; `RunRegistry.query` (and
`python -m repro.profile query`) filters runs by metadata predicates, so
"all runs of arch X on mesh Y" is one call away and `diff`/`timeline`
always have a baseline to point at.

Registration is idempotent and multi-writer: every rank / replica of a
run calls `register_run` on the same dir; writers merge into the
manifest's `writers` list and the earliest start time wins.  Writes are
atomic (tmp + rename), mirroring the snapshot writer.
"""

from __future__ import annotations

import fnmatch
import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .snapshot import SCHEMA_VERSION

MANIFEST_NAME = "manifest.json"


@contextmanager
def _manifest_lock(run_dir: str):
    """Serialize register_run's load-modify-save: ranks of one run race on
    the same manifest, and a lost update would drop writer entries.  flock
    is advisory and Linux-only-reliable, which matches where fleets run;
    hosts without fcntl fall back to best-effort (single-writer) behavior."""
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-posix fallback
        yield
        return
    os.makedirs(run_dir, exist_ok=True)
    fd = os.open(os.path.join(run_dir, MANIFEST_NAME + ".lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)

MeshShape = Optional[Tuple[int, ...]]


def _jax_version() -> str:
    # the PyTorch package never imports jax: manifests it writes leave
    # jax_version empty, as a jax-less host of the reference does
    return ""


def parse_mesh(mesh: Union[None, str, Sequence[int]]) -> MeshShape:
    """'4x2' / (4, 2) / [4, 2] -> (4, 2); ''/None -> None."""
    if mesh is None or mesh == "":
        return None
    if isinstance(mesh, str):
        return tuple(int(x) for x in mesh.split("x"))
    return tuple(int(x) for x in mesh)


def kv_pair(s: str) -> Tuple[str, str]:
    """argparse type for KEY=VALUE flags (--profile-meta / --where): fail
    at the parser with a usage error, not deep in a dict() later."""
    key, sep, value = s.partition("=")
    if not sep or not key:
        import argparse
        raise argparse.ArgumentTypeError(
            f"expected KEY=VALUE, got {s!r}")
    return key, value


@dataclass
class RunManifest:
    """One run's structured metadata (the per-run half of the registry)."""

    run_dir: str = ""                    # filled at load; not serialized
    config: str = ""                     # config name (e.g. tinyllama_1_1b)
    arch: str = ""                       # model family (dense/moe/ssm/...)
    mesh_shape: MeshShape = None
    mesh_axes: Optional[Tuple[str, ...]] = None
    label: str = ""
    kind: str = ""                       # train | serve | ...
    jax_version: str = ""
    schema: int = SCHEMA_VERSION
    started_at: float = 0.0
    meta: Dict[str, Any] = field(default_factory=dict)
    writers: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def run_id(self) -> str:
        return os.path.basename(os.path.normpath(self.run_dir)) or self.run_dir

    # -- (de)serialization ----------------------------------------------------
    def to_json(self) -> dict:
        d = asdict(self)
        d.pop("run_dir")
        d["mesh_shape"] = list(self.mesh_shape) if self.mesh_shape else None
        d["mesh_axes"] = list(self.mesh_axes) if self.mesh_axes else None
        return d

    @staticmethod
    def from_json(d: dict, run_dir: str = "") -> "RunManifest":
        return RunManifest(
            run_dir=run_dir,
            config=d.get("config", ""),
            arch=d.get("arch", ""),
            mesh_shape=parse_mesh(d.get("mesh_shape")),
            mesh_axes=tuple(d["mesh_axes"]) if d.get("mesh_axes") else None,
            label=d.get("label", ""),
            kind=d.get("kind", ""),
            jax_version=d.get("jax_version", ""),
            schema=int(d.get("schema", SCHEMA_VERSION)),
            started_at=float(d.get("started_at", 0.0)),
            meta=dict(d.get("meta", {})),
            writers=list(d.get("writers", [])),
        )

    @staticmethod
    def load(run_dir: str) -> "RunManifest":
        with open(os.path.join(run_dir, MANIFEST_NAME)) as f:
            return RunManifest.from_json(json.load(f), run_dir=run_dir)

    def save(self) -> str:
        path = os.path.join(self.run_dir, MANIFEST_NAME)
        os.makedirs(self.run_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.run_dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    # -- predicates ------------------------------------------------------------
    def matches(self, config: Optional[str] = None,
                arch: Optional[str] = None,
                mesh: Union[None, str, Sequence[int]] = None,
                label: Optional[str] = None,
                kind: Optional[str] = None,
                since: Optional[float] = None,
                where: Optional[Dict[str, str]] = None) -> bool:
        """Metadata predicate; string fields accept fnmatch globs, `mesh`
        accepts '4x2' or a shape tuple, `since` is an epoch lower bound on
        started_at, `where` matches free-form keys against top-level fields
        first and then `meta` (string compare)."""
        for pat, val in ((config, self.config), (arch, self.arch),
                         (label, self.label), (kind, self.kind)):
            if pat is not None and not fnmatch.fnmatchcase(val, pat):
                return False
        if mesh is not None and parse_mesh(mesh) != self.mesh_shape:
            return False
        if since is not None and self.started_at < since:
            return False
        for k, v in (where or {}).items():
            have = getattr(self, k, None)
            if have is None or isinstance(have, (dict, list)):
                have = self.meta.get(k)
            if have is None or str(have) != str(v):
                return False
        return True

    def describe(self) -> str:
        mesh = "x".join(map(str, self.mesh_shape)) if self.mesh_shape else "-"
        when = time.strftime("%Y-%m-%dT%H:%M:%S",
                             time.localtime(self.started_at)) \
            if self.started_at else "-"
        return (f"{self.run_dir}  config={self.config or '-'} "
                f"arch={self.arch or '-'} mesh={mesh} "
                f"label={self.label or '-'} kind={self.kind or '-'} "
                f"started={when} writers={len(self.writers)}")


def register_run(run_dir: str, *,
                 config: str = "", arch: str = "",
                 mesh_shape: Union[None, str, Sequence[int]] = None,
                 mesh_axes: Optional[Sequence[str]] = None,
                 label: str = "", kind: str = "",
                 meta: Optional[Dict[str, Any]] = None,
                 started_at: Optional[float] = None) -> RunManifest:
    """Create or update `run_dir`'s manifest (idempotent, multi-writer).

    Called by every writing process at run start; concurrent ranks merge
    into one manifest: earliest started_at wins, meta keys union (latest
    write wins per key), and each (label, host, pid) appears once in
    `writers`.
    """
    now = time.time() if started_at is None else started_at
    with _manifest_lock(run_dir):
        try:
            m = RunManifest.load(run_dir)
        except (FileNotFoundError, json.JSONDecodeError, ValueError):
            m = RunManifest(run_dir=run_dir, started_at=now)
        m.run_dir = run_dir
        m.started_at = min(m.started_at or now, now)
        if config:
            m.config = config
        if arch:
            m.arch = arch
        if mesh_shape is not None:
            m.mesh_shape = parse_mesh(mesh_shape)
        if mesh_axes is not None:
            m.mesh_axes = tuple(mesh_axes)
        if label:
            m.label = label
        if kind:
            m.kind = kind
        m.jax_version = m.jax_version or _jax_version()
        m.schema = SCHEMA_VERSION
        m.meta.update(meta or {})
        from .store import host_label
        writer = {"label": label, "host": host_label(),
                  "pid": os.getpid()}
        ident = (writer["label"], writer["host"], writer["pid"])
        if ident not in {(w.get("label"), w.get("host"), w.get("pid"))
                         for w in m.writers}:
            m.writers.append(dict(writer, registered_at=now))
        m.save()
    return m


class RunRegistry:
    """All registered runs under a root directory tree."""

    def __init__(self, root: str) -> None:
        self.root = root

    def run_dirs(self) -> List[str]:
        hits = glob_manifests(self.root)
        return sorted(os.path.dirname(p) for p in hits)

    def runs(self) -> List[RunManifest]:
        """Load every registered run from ONE snapshot of the directory
        listing.  The registry is scanned while publishers/collectors
        register concurrently (fleet spools grow mid-query), so a run
        dir that appears after the listing is simply absent from this
        scan, and one whose manifest vanishes or is mid-merge between
        listing and load is skipped — never an exception out of query.
        """
        out = []
        for d in self.run_dirs():
            try:
                out.append(RunManifest.load(d))
            except FileNotFoundError:
                continue          # registered mid-scan and gone, or racing
            except (json.JSONDecodeError, ValueError, OSError) as e:
                import warnings
                warnings.warn(f"run registry: skipping unreadable manifest "
                              f"in {d!r}: {e}", stacklevel=2)
        out.sort(key=lambda m: (m.started_at, m.run_dir))
        return out

    def query(self, **predicates) -> List[RunManifest]:
        """Filter runs by RunManifest.matches predicates (config, arch,
        mesh, label, kind, since, where)."""
        return [m for m in self.runs() if m.matches(**predicates)]

    def find(self, pattern: Optional[str] = None) -> str:
        """Resolve ONE run dir by a run-id / label / config fnmatch glob
        (`diagnose --run`, `--baseline`).  No pattern picks the sole
        registered run; zero or several matches raise LookupError listing
        the candidates — selection must be explicit, never first-match."""
        runs = self.runs()
        if pattern:
            runs = [m for m in runs
                    if fnmatch.fnmatchcase(m.run_id, pattern)
                    or fnmatch.fnmatchcase(m.label, pattern)
                    or fnmatch.fnmatchcase(m.config, pattern)]
        what = f"pattern {pattern!r}" if pattern else "an implicit run"
        if not runs:
            raise LookupError(f"no registered run under {self.root!r} "
                              f"matches {what}")
        if len(runs) > 1:
            ids = ", ".join(m.run_id for m in runs)
            raise LookupError(f"{what} is ambiguous under {self.root!r}: "
                              f"matches [{ids}] — narrow it (--run takes "
                              f"run-id/label/config globs)")
        return runs[0].run_dir


def glob_manifests(root: str) -> List[str]:
    import glob as _glob
    direct = os.path.join(root, MANIFEST_NAME)
    hits = set(_glob.glob(os.path.join(root, "**", MANIFEST_NAME),
                          recursive=True))
    if os.path.exists(direct):
        hits.add(direct)
    return sorted(hits)
