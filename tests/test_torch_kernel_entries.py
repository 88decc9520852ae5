"""The ctypes declarations of the port's CUDA entry points against their C
signatures.

``ray_tpu_torch/ops/_build.py::_ENTRIES`` declares, for each library, every
``extern "C"`` function of ``csrc/<name>.cu`` with its argument types.
ctypes passes an undeclared or wrongly declared argument as a 32-bit int:
a pointer is cut, or every argument after a missing one lands in the
wrong register. Nothing on a CPU runs the kernels, so this test reads each
signature from the source and holds the declaration to it: pointers as
``c_void_p``, ``int`` as ``c_int``, the same count and the same return
type. ``_build`` imports no torch, so it is imported here directly (the
other port tests keep torch out of the pytest worker)."""

import ctypes
import os
import re

import pytest

from ray_tpu_torch.ops import _build


def _signatures(src: str):
    """{function: (return type, [parameter declarations])} of every
    ``extern "C"`` function defined in the CUDA source ``src``."""
    with open(src) as f:
        text = f.read()
    text = re.sub(r"//[^\n]*", "", text)  # comments
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', text):
        params = [p.strip() for p in m.group(3).split(",") if p.strip()]
        out[m.group(2)] = (m.group(1), params)
    return out


def _ctype(decl: str):
    """The ctypes type a C parameter declaration must be given."""
    if "*" in decl:
        return ctypes.c_void_p
    if re.fullmatch(r"(const\s+)?int\s+\w+", decl):
        return ctypes.c_int
    raise AssertionError(f"no ctypes rule for C parameter {decl!r}")


@pytest.mark.parametrize("lib", sorted(_build._ENTRIES))
def test_entry_argtypes_match_the_c_signature(lib):
    """Every function ``_ENTRIES[lib]`` declares is defined ``extern "C"``
    in ``csrc/<lib>.cu`` with an ``int`` return, and its argtypes match the
    C parameters one for one; the source defines no entry point that is not
    declared."""
    src = os.path.join(_build._CSRC, f"{lib}.cu")
    sigs = _signatures(src)
    assert set(sigs) == set(_build._ENTRIES[lib]), (
        f"{lib}.cu defines {sorted(sigs)}, _ENTRIES declares "
        f"{sorted(_build._ENTRIES[lib])}")
    for fn, (restype, argtypes) in _build._ENTRIES[lib].items():
        c_ret, params = sigs[fn]
        assert c_ret == "int" and restype is ctypes.c_int, (fn, c_ret)
        want = [_ctype(p) for p in params]
        assert len(argtypes) == len(want), (
            f"{fn}: {len(argtypes)} argtypes for {len(want)} C parameters "
            f"{params}")
        for i, (got, typ, decl) in enumerate(zip(argtypes, want, params)):
            assert got is typ, f"{fn} argument {i} ({decl}): {got} != {typ}"
