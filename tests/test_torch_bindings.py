"""The ctypes bindings of the CUDA kernels against their sources.

`tnqs_torch/ops/_build.py::_SIGNATURES` declares the argument types ctypes
passes to each `extern "C"` entry of `tnqs_torch/csrc/*.cu`.  A declaration
that lags its entry (an argument added to the C side only) passes a float
where an int is read, or shifts every argument after it; the libraries build
only on the card, so the CPU holds the two against each other by parsing the
sources."""

import ctypes
import re

import pytest

from tnqs_torch.ops import _build

_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
# a parameter's C type -> its ctypes type; any other pointer is passed as void*
_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "int*": ctypes.POINTER(ctypes.c_int)}


def _entries():
    """name -> the ctypes types of its parameters, from the sources."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in _ENTRY.findall(src.read_text()):
            types = []
            for p in params.split(","):
                ctype = "".join(p.replace("const ", "").replace("*", "* ").split()[:-1])
                types.append(_TYPES[ctype] if ctype in _TYPES else ctypes.c_void_p if ctype.endswith("*") else ctype)
            out[name] = types
    return out


def test_every_entry_is_bound():
    """Each `extern "C"` entry of the sources has a declaration, and each
    declaration an entry."""
    assert sorted(_entries()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_binding_matches_the_source(name):
    """The declared argument types are the entry's parameter types, in
    order."""
    assert _build._SIGNATURES[name] == _entries()[name]
