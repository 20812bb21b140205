"""Merlin transcripts (bit-exact with merlin v4 / the xelis merlin fork).

Reference call sites: xelis-he/src/transcript.rs (trait over
merlin::Transcript), proofs.rs, tx/builder.rs, tx/verify.rs.

Uses the native C++ STROBE implementation (hashcore/csrc) when available,
falling back to the pure-Python Strobe128.
"""

from __future__ import annotations

from .keccak import Strobe128

try:  # native accelerated transcript (ctypes); optional
    from .native import NativeStrobe128 as _FastStrobe  # type: ignore
except Exception:  # pragma: no cover - native build unavailable
    _FastStrobe = None

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"


def _u32le(n: int) -> bytes:
    return n.to_bytes(4, "little")


# record-prefix cache: verification replays use a small fixed set of
# (label, message_length) pairs, so the whole record except the message
# bytes is memoized (cuts per-append Python work ~3x on the hot path)
_PREFIX_CACHE: dict[tuple[bytes, int], bytes] = {}


def _record_prefix(label: bytes, msg_len: int) -> bytes:
    key = (label, msg_len)
    pre = _PREFIX_CACHE.get(key)
    if pre is None:
        pre = _PREFIX_CACHE[key] = (
            b"\x00\x00" + _u32le(len(label)) + label
            + b"\x00\x01\x04\x00\x00\x00" + _u32le(msg_len)
            + b"\x01\x00" + _u32le(msg_len)
        )
    return pre


_CHALLENGE_PREFIX_CACHE: dict[tuple[bytes, int], bytes] = {}


def _challenge_record(label: bytes, n: int) -> bytes:
    key = (label, n)
    rec = _CHALLENGE_PREFIX_CACHE.get(key)
    if rec is None:
        rec = _CHALLENGE_PREFIX_CACHE[key] = (
            b"\x00\x00" + _u32le(len(label)) + label
            + b"\x00\x01\x04\x00\x00\x00" + _u32le(n)
            + b"\x02\x00" + _u32le(n)
        )
    return rec


class Transcript:
    """merlin::Transcript equivalent.

    Appends are BUFFERED as serialized STROBE op records and flushed in one
    native call per challenge (``run_batch``): the Fiat-Shamir replay of a
    whole block then costs ~1 FFI round trip per challenge instead of 3 per
    append, which dominates host verification time otherwise.  Byte
    semantics are identical to eager execution — STROBE ops are sequential
    state transitions either way.
    """

    __slots__ = ("strobe", "_pend")

    def __init__(self, label: bytes, _strobe=None):
        self._pend: list[bytes] = []
        if _strobe is not None:
            self.strobe = _strobe
            return
        cls = _FastStrobe if _FastStrobe is not None else Strobe128
        self.strobe = cls(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        # records: u8 op (0=meta_ad, 1=ad, 2=prf), u8 more, u32le len, data
        self._pend.append(_record_prefix(label, len(message)) + message)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, value.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self._pend.append(_challenge_record(label, n))
        blob = b"".join(self._pend)
        self._pend.clear()
        return self.strobe.run_batch(blob, n)

    def _flush(self) -> None:
        if self._pend:
            blob = b"".join(self._pend)
            self._pend.clear()
            self.strobe.run_batch(blob, 0)

    # -- native fold-engine integration --------------------------------------

    def native_handle(self):
        """Raw Strobe* for the C++ verification-fold engine, or None when
        running on the pure-Python STROBE."""
        return getattr(self.strobe, "_h", None)

    def take_pending(self) -> bytes:
        """Drain the buffered op records (the caller will execute them,
        e.g. inside a native fold call operating on the same strobe)."""
        if not self._pend:
            return b""
        blob = b"".join(self._pend)
        self._pend.clear()
        return blob

    def clone(self) -> "Transcript":
        self._flush()
        return type(self)(b"", _strobe=self.strobe.copy())
