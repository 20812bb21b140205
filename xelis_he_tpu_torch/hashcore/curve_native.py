"""ctypes loader/builder for the host ristretto255 engine
(csrc/curve25519.cpp -> libxhecurve.so).

Import failure is non-fatal: pyref falls back to pure Python ints.
Set XELIS_HE_TPU_NO_CURVE_NATIVE=1 to force the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

if os.environ.get("XELIS_HE_TPU_NO_CURVE_NATIVE"):
    raise ImportError("curve native disabled by env")

_DIR = pathlib.Path(__file__).parent / "csrc"
_SRC = _DIR / "curve25519.cpp"
_LIB = _DIR / "libxhecurve.so"


def _build() -> pathlib.Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    with tempfile.NamedTemporaryFile(dir=_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(_SRC), "-o", str(tmp_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
    except Exception:
        tmp_path.unlink(missing_ok=True)
        raise
    os.replace(tmp_path, _LIB)
    return _LIB


lib = ctypes.CDLL(str(_build()))

_vp = ctypes.c_void_p
_sz = ctypes.c_size_t

lib.xhe_pt_add.argtypes = [_vp, _vp, _vp]
lib.xhe_pt_dbl.argtypes = [_vp, _vp]
lib.xhe_pt_neg.argtypes = [_vp, _vp]
lib.xhe_pt_mul.argtypes = [_vp, _vp, _vp]
lib.xhe_pt_eq.argtypes = [_vp, _vp]
lib.xhe_pt_eq.restype = ctypes.c_int
lib.xhe_pt_compress.argtypes = [_vp, _vp]
lib.xhe_pt_decompress.argtypes = [_vp, _vp]
lib.xhe_pt_decompress.restype = ctypes.c_int
lib.xhe_pt_msm.argtypes = [_vp, _vp, _sz, _vp]
