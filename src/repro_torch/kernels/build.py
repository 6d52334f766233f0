"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` is compiled by nvcc for Hopper (sm_90a) into
its own shared library with a plain C interface, loaded with ctypes.  A
library is keyed by a hash of its source, the shared headers and the
flags, so an edited kernel rebuilds and an unchanged one is reused.  The
first call builds whatever is missing; `build()` compiles several
sources at once, one nvcc process each.

Libraries land in `build/repro_torch_kernels/` at the root of the
checkout (listed in .gitignore).  Nothing here runs at import time: this
module is imported on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rmsnorm", "decode_attention", "mla_attention", "flash_attention",
           "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signature of every entry point (all return the launch's cudaError_t)
SIGNATURES = {
    "rmsnorm": {
        "rmsnorm_launch": (_P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _F,
                           _I, _P),
        "rmsnorm_add_launch": (_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _F,
                               _I, _P),
        "rmsnorm_bwd_launch": (_P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                               _I, _I, _I, _I, _I, _F, _I, _P),
    },
    "decode_attention": {
        "decode_attention_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
        "chunk_attention_launch": (_P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I,
                                   _F, _I, _P),
        "decode_attention_paged_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _I, _I,
                                          _I, _F, _I, _P),
        "chunk_attention_paged_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _I, _I, _I,
                                         _I, _I, _F, _I, _P),
    },
    "mla_attention": {
        "mla_decode_attention_launch": (_P,) * 9 + (_I,) * 5 + (_F, _I, _P),
        "mla_decode_attention_paged_launch": (_P,) * 8 + (_I,) * 7
        + (_F, _I, _P),
        "mla_chunk_attention_launch": (_P,) * 7 + (_I,) * 6 + (_F, _I, _P),
        "mla_chunk_attention_paged_launch": (_P,) * 8 + (_I,) * 8
        + (_F, _I, _P),
    },
    "flash_attention": {
        "flash_attention_fwd_launch": (_P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I,
                                       _F, _F, _I, _P),
        "flash_attention_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                       _F, _F, _I, _P),
    },
    "mamba_scan": {
        "ssd_scan_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P),
        "ssd_scan_bwd_launch": (_P,) * 18 + (_I,) * 7 + (_P,),
        "ssd_scan_bwd_tc_launch": (_P,) * 20 + (_I,) * 7 + (_P,),
        "ssd_scan_bwd_occupancy": (_I, _I, _I),
    },
}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library of `names`, one nvcc process per
    source, all started together.  The compiler's report (registers,
    shared memory, spills from -Xptxas -v) is kept beside each library as
    `<lib>.log`.  Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n}.cu:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's report for the current build of `name` ('' if none)."""
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `name`, built first if missing, with argtypes
    and restype set on every entry point."""
    lib = ctypes.CDLL(str(build([name])[name]))
    for fn, args in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(args)
        f.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error "
                           f"{err}")
