"""ctypes loader/builder for the native IPP prover session
(csrc/prover.cpp -> libxheprover.so).

Same build pattern as verifyfold_native.py.  Import failure is non-fatal:
the inner-product prover falls back to the Python/byte-MSM path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent / "csrc"
_SRC = _DIR / "prover.cpp"
_DEPS = [_DIR / "curve25519.cpp", _DIR / "scalarops.cpp"]
_LIB = _DIR / "libxheprover.so"


def _build() -> pathlib.Path:
    newest = max(p.stat().st_mtime for p in [_SRC, *_DEPS])
    if _LIB.exists() and _LIB.stat().st_mtime >= newest:
        return _LIB
    with tempfile.NamedTemporaryFile(dir=_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(tmp_path),
    ]
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

lib.xhe_ipp_gens_register.argtypes = [_sz, _vp, _vp]  # n, G packed, H packed
lib.xhe_ipp_gens_register.restype = ctypes.c_int

lib.xhe_ipp_new.argtypes = [
    _sz,       # n
    ctypes.c_int,  # gens_id (-1 = Pippenger fallback)
    _vp, _vp,  # G packed, H packed (n x 128B)
    _vp,       # Q packed
    _vp, _vp,  # G_factors, H_factors (n x 32B)
    _vp, _vp,  # a, b (n x 32B)
]
lib.xhe_ipp_new.restype = _vp

lib.xhe_gens_msm.argtypes = [
    ctypes.c_int,  # gens_id
    _vp, _vp, _sz,  # gen_idx (uint32), scalars (n x 32B), n_lanes
    _vp, _vp, _sz,  # extra scalars, extra packed points, n_extra
    _vp,            # out32
]
lib.xhe_gens_msm.restype = ctypes.c_int

lib.xhe_ipp_round.argtypes = [_vp, _vp, _vp, _vp]  # handle, u_prev, L_out, R_out
lib.xhe_ipp_round.restype = ctypes.c_int

lib.xhe_ipp_final.argtypes = [_vp, _vp, _vp, _vp]  # handle, u_last, a_out, b_out
lib.xhe_ipp_final.restype = ctypes.c_int

lib.xhe_ipp_free.argtypes = [_vp]
lib.xhe_ipp_free.restype = None

lib.xhe_ipp_set_threads.argtypes = [ctypes.c_int]
lib.xhe_ipp_set_threads.restype = None
