"""The ctypes contract of the port's CUDA kernels, on the CPU.

Every `extern "C" int <name>(...)` in `src/repro_torch/kernels/csrc/*.cu`
is parsed from the source and held against `kernels/build.py::SIGNATURES`
in both directions: the same entry points per source, the same arity, and
at each position the same kind (pointer, int, long long or float).  A
launch signature that drifts from its ctypes declaration would pass
pointers as ints or shift every later argument; nothing else catches it
without the card.
"""

import ctypes
import re

import pytest

from repro_torch.kernels import build

ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
         ctypes.c_longlong: "long long", ctypes.c_float: "float"}


def c_kind(param: str) -> str:
    """The kind of one C parameter declaration, e.g. 'const void* q'."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
    assert ctype in ("int", "long long", "float"), decl
    return ctype


def entry_points(source: str) -> dict:
    """{name: [kind of each parameter]} of a source's extern "C" functions."""
    text = (build.CSRC / f"{source}.cu").read_text()
    return {name: [c_kind(p) for p in params.split(",")]
            for name, params in ENTRY.findall(text)}


def test_every_source_has_its_file_and_signatures():
    assert set(build.SIGNATURES) == set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file(), name


@pytest.mark.parametrize("source", build.SOURCES)
def test_entry_points_match_the_ctypes_signatures(source):
    parsed = entry_points(source)
    declared = build.SIGNATURES[source]
    assert parsed, f"{source}.cu declares no extern \"C\" entry point"
    assert set(parsed) == set(declared), (sorted(parsed), sorted(declared))
    for fn, kinds in parsed.items():
        want = [KINDS[t] for t in declared[fn]]
        assert len(kinds) == len(want), (fn, len(kinds), len(want))
        assert kinds == want, (fn, kinds, want)


def test_the_parser_reads_each_kind():
    text = ('extern "C" int f(const void* a, void* b, long long n,\n'
            '                 int d, float eps) {')
    [(name, params)] = ENTRY.findall(text)
    assert name == "f"
    assert [c_kind(p) for p in params.split(",")] == [
        "pointer", "pointer", "long long", "int", "float"]
