"""ChaCha20 stream cipher (RFC 8439 flavor, 12-byte nonce, counter from 0).

Matches the RustCrypto ``chacha20`` crate used by the reference for extra-data
encryption (xelis-he/src/extra_data.rs:41-46): raw keystream XOR with
initial block counter 0.  Prefers the ``cryptography`` package's native
ChaCha20 (same construction; its 16-byte nonce is counter||nonce), falling
back to a pure-Python implementation.
"""

from __future__ import annotations

import struct

try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms

    def chacha20_xor(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
        assert len(key) == 32 and len(nonce) == 12
        full_nonce = counter.to_bytes(4, "little") + nonce
        enc = Cipher(algorithms.ChaCha20(key, full_nonce), mode=None).encryptor()
        return enc.update(data)

    _HAVE_NATIVE = True
except Exception:  # pragma: no cover
    _HAVE_NATIVE = False


def _quarter(st, a, b, c, d):
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] ^= st[a]
    st[d] = ((st[d] << 16) | (st[d] >> 16)) & 0xFFFFFFFF
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] ^= st[c]
    st[b] = ((st[b] << 12) | (st[b] >> 20)) & 0xFFFFFFFF
    st[a] = (st[a] + st[b]) & 0xFFFFFFFF
    st[d] ^= st[a]
    st[d] = ((st[d] << 8) | (st[d] >> 24)) & 0xFFFFFFFF
    st[c] = (st[c] + st[d]) & 0xFFFFFFFF
    st[b] ^= st[c]
    st[b] = ((st[b] << 7) | (st[b] >> 25)) & 0xFFFFFFFF


def _block(key_words, counter, nonce_words):
    st = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
          *key_words, counter, *nonce_words]
    working = list(st)
    for _ in range(10):
        _quarter(working, 0, 4, 8, 12)
        _quarter(working, 1, 5, 9, 13)
        _quarter(working, 2, 6, 10, 14)
        _quarter(working, 3, 7, 11, 15)
        _quarter(working, 0, 5, 10, 15)
        _quarter(working, 1, 6, 11, 12)
        _quarter(working, 2, 7, 8, 13)
        _quarter(working, 3, 4, 9, 14)
    return struct.pack("<16I", *[(w + s) & 0xFFFFFFFF for w, s in zip(working, st)])


def _chacha20_xor_py(key: bytes, nonce: bytes, data: bytes, counter: int = 0) -> bytes:
    assert len(key) == 32 and len(nonce) == 12
    key_words = struct.unpack("<8I", key)
    nonce_words = struct.unpack("<3I", nonce)
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        ks = _block(key_words, counter + i // 64, nonce_words)
        chunk = data[i:i + 64]
        out[i:i + len(chunk)] = bytes(a ^ b for a, b in zip(chunk, ks))
    return bytes(out)


if not _HAVE_NATIVE:
    chacha20_xor = _chacha20_xor_py
