"""ctypes loader/builder for the native verification-fold engine
(csrc/verifyfold.cpp -> libxheverify.so).

Same build pattern as native.py / scalarops_native.py.  Import failure is
non-fatal: the bulletproofs verifier falls back to the Python fold.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent / "csrc"
_SRC = _DIR / "verifyfold.cpp"
_DEPS = [_DIR / "hashcore.cpp", _DIR / "keccak_unrolled.inc", _DIR / "scalarops.cpp"]
_LIB = _DIR / "libxheverify.so"


def _build() -> pathlib.Path:
    newest = max(p.stat().st_mtime for p in [_SRC, *_DEPS])
    if _LIB.exists() and _LIB.stat().st_mtime >= newest:
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

lib.xhe_bp_fold.argtypes = [
    _vp,       # Strobe*
    _vp, _sz,  # pend, pend_len
    _vp,       # pts (A,S,T1,T2)
    _vp, _sz,  # lr, lg_n
    _vp,       # sc3 (t_x, t_x_blinding, e_blinding)
    _vp,       # ab
    _vp, _sz,  # V, m
    _sz,       # n_bits
    _vp, _vp,  # rho, c
    _vp,       # dyn_out
    _vp, _vp,  # g_acc, h_acc
    _vp, _vp,  # b_acc, bb_acc
]
lib.xhe_bp_fold.restype = ctypes.c_int

lib.xhe_eq_fold.argtypes = [
    _vp,       # Strobe*
    _vp, _sz,  # pend, pend_len
    _vp,       # Y_0||Y_1||Y_2
    _vp,       # z_s||z_x||z_r
    _vp,       # batch factor
    _vp,       # out9
]
lib.xhe_eq_fold.restype = ctypes.c_int

lib.xhe_validity_fold.argtypes = [
    _vp,       # Strobe*
    _vp, _sz,  # pend, pend_len
    _vp,       # Y_0||Y_1||Y_2
    _vp,       # z_r||z_x
    _vp,       # batch factor
    _vp,       # out10
]
lib.xhe_validity_fold.restype = ctypes.c_int

lib.xhe_tx_fold.argtypes = [
    _vp,       # Strobe*
    _vp, _sz,  # script, script_len
    _vp,       # out scalars
    _vp, _vp,  # g_acc, h_acc
    _vp, _vp,  # b_acc, bb_acc
]
lib.xhe_tx_fold.restype = ctypes.c_int

lib.xhe_tx_fold_group.argtypes = [
    _sz,       # n
    _vp,       # uint64 Strobe* array
    _vp,       # concatenated script blob
    _vp,       # uint64 byte offsets (n+1)
    _vp,       # out scalar blob
    _vp,       # uint64 out row offsets (n+1)
    _vp, _vp,  # g_acc, h_acc
    _vp, _vp,  # b_acc, bb_acc
    _vp,       # int32 rcs array
]
lib.xhe_tx_fold_group.restype = ctypes.c_int
