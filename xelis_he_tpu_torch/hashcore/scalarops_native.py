"""ctypes loader/builder for the C++ scalar engine (csrc/scalarops.cpp).

Same build pattern as hashcore/native.py: g++ on first import, atomic
replace, cached by mtime.  Import failure is non-fatal — scalarops.py falls
back to pure Python.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

_SRC = pathlib.Path(__file__).parent / "csrc" / "scalarops.cpp"
_LIB = pathlib.Path(__file__).parent / "csrc" / "libxhescalar.so"


def _build() -> pathlib.Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    with tempfile.NamedTemporaryFile(dir=_LIB.parent, suffix=".so", delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        tmp_path.unlink(missing_ok=True)
        raise
    os.replace(tmp_path, _LIB)
    return _LIB


lib = ctypes.CDLL(str(_build()))

# void* instead of u8*: callers pass ``arr.ctypes.data`` (a plain int),
# which skips a ctypes cast object per argument on the hot path
_u8p = ctypes.c_void_p
_sz = ctypes.c_size_t

for _name, _args in {
    "xhe_sc_mul": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_muls": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_add": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_sub": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_axpy": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_powers": [_u8p, _u8p, _sz],
    "xhe_sc_inner": [_u8p, _u8p, _u8p, _sz],
    "xhe_sc_sum": [_u8p, _u8p, _sz],
    "xhe_sc_invert": [_u8p, _u8p, _sz],
    "xhe_sc_ipp_s": [_u8p, _u8p, _sz, _u8p, _sz],
    "xhe_sc_bp_h": [_u8p, _u8p, _u8p, _u8p, _u8p, _u8p, _sz, _sz, _u8p],
}.items():
    fn = getattr(lib, _name)
    fn.argtypes = _args
    fn.restype = None
