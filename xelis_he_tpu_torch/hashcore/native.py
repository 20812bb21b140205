"""ctypes loader/builder for the C++ hashcore (csrc/hashcore.cpp).

Builds ``libxhehashcore.so`` with g++ on first import (cached next to the
source, rebuilt when the source is newer).  Every exported symbol has a
pure-Python fallback in this package, so import failures are non-fatal —
callers catch ImportError and fall back.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

_SRC = pathlib.Path(__file__).parent / "csrc" / "hashcore.cpp"
_LIB = pathlib.Path(__file__).parent / "csrc" / "libxhehashcore.so"


def _build() -> pathlib.Path:
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    # build into a temp file then atomically move, so concurrent importers
    # never load a half-written library
    with tempfile.NamedTemporaryFile(
        dir=_LIB.parent, suffix=".so", delete=False
    ) as tmp:
        tmp_path = pathlib.Path(tmp.name)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        str(_SRC), "-o", str(tmp_path),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        tmp_path.unlink(missing_ok=True)
        raise
    os.replace(tmp_path, _LIB)
    return _LIB


_lib = ctypes.CDLL(str(_build()))

_lib.xhe_strobe_new.restype = ctypes.c_void_p
_lib.xhe_strobe_new.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
_lib.xhe_strobe_copy.restype = ctypes.c_void_p
_lib.xhe_strobe_copy.argtypes = [ctypes.c_void_p]
_lib.xhe_strobe_free.argtypes = [ctypes.c_void_p]
for _name in ("xhe_strobe_meta_ad", "xhe_strobe_ad", "xhe_strobe_key"):
    fn = getattr(_lib, _name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
    fn.restype = None
_lib.xhe_strobe_prf.argtypes = [
    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int
]
_lib.xhe_strobe_batch.argtypes = [
    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p
]
_lib.xhe_strobe_batch.restype = ctypes.c_size_t
_lib.xhe_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]
_lib.xhe_chacha20_xor.argtypes = [
    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t
]
_lib.xhe_keccak_f1600.argtypes = [ctypes.c_char_p]
_lib.xhe_sha3_512.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p]


class NativeStrobe128:
    """Drop-in replacement for hashcore.keccak.Strobe128 backed by C++."""

    __slots__ = ("_h",)

    def __init__(self, protocol_label: bytes, _handle=None):
        if _handle is not None:
            self._h = _handle
        else:
            self._h = _lib.xhe_strobe_new(protocol_label, len(protocol_label))

    # bind the free function at class scope: module globals may already be
    # cleared when __del__ runs at interpreter shutdown
    _free = _lib.xhe_strobe_free

    def __del__(self, _free=_free):  # pragma: no cover
        h = getattr(self, "_h", None)
        if h:
            _free(h)
            self._h = None

    def copy(self) -> "NativeStrobe128":
        return NativeStrobe128(b"", _handle=_lib.xhe_strobe_copy(self._h))

    def meta_ad(self, data: bytes, more: bool) -> None:
        _lib.xhe_strobe_meta_ad(self._h, data, len(data), int(more))

    def ad(self, data: bytes, more: bool) -> None:
        _lib.xhe_strobe_ad(self._h, data, len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        _lib.xhe_strobe_prf(self._h, out, n, int(more))
        return out.raw

    def key(self, data: bytes, more: bool) -> None:
        _lib.xhe_strobe_key(self._h, data, len(data), int(more))

    def run_batch(self, blob: bytes, out_len: int) -> bytes:
        """Execute a serialized op list (merlin.py record format) in ONE
        native call; returns the concatenated prf outputs."""
        out = ctypes.create_string_buffer(out_len) if out_len else None
        _lib.xhe_strobe_batch(self._h, blob, len(blob), out)
        return out.raw if out is not None else b""


def blake3(data: bytes, out_len: int = 32) -> bytes:
    assert out_len == 32, "native blake3 is fixed to 32-byte output"
    out = ctypes.create_string_buffer(32)
    _lib.xhe_blake3(data, len(data), out)
    return out.raw


def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    buf = ctypes.create_string_buffer(data, len(data))
    _lib.xhe_chacha20_xor(key, nonce, counter, buf, len(data))
    return buf.raw


def sha3_512(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(64)
    _lib.xhe_sha3_512(data, len(data), out)
    return out.raw


def keccak_f1600(state: bytearray) -> None:
    buf = ctypes.create_string_buffer(bytes(state), 200)
    _lib.xhe_keccak_f1600(buf)
    state[:] = buf.raw[:200]
