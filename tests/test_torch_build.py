"""The port's one ctypes binding (`ops/_build.py::ENTRY_TYPES`) against the
`extern "C"` declarations of the CUDA sources it calls. A wrong argument
list corrupts the arguments with no error, so each entry point's types are
held to its C declaration here, on the CPU, without nvcc."""

import ctypes
import glob
import os
import re

import pytest

from nerf_workspaces_explorer_tpu_torch.ops import _build

DECLARATION = re.compile(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _declarations() -> dict:
    """name -> the parameter list of every `extern "C"` entry in csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        with open(path) as f:
            for name, params in DECLARATION.findall(f.read()):
                out[name] = [p.strip() for p in params.split(",") if p.strip()]
    return out


def _ctype(param: str):
    """The ctypes type a C parameter crosses as."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(None, 1)[0].replace("const", "").strip()
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[kind]


def test_every_declaration_has_an_entry():
    assert sorted(_declarations()) == sorted(_build.ENTRY_TYPES)


@pytest.mark.parametrize("symbol", sorted(_build.ENTRY_TYPES))
def test_entry_types_match_c_declaration(symbol):
    params = _declarations()[symbol]
    assert len(_build.ENTRY_TYPES[symbol]) == len(params)
    for i, (have, param) in enumerate(zip(_build.ENTRY_TYPES[symbol], params)):
        assert have is _ctype(param), f"{symbol} argument {i} ({param}): {have.__name__}"
