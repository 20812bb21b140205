"""BLAKE3 hash (pure-Python fallback; 32-byte output).

The reference uses blake3 for transaction hashing in the multisig flow
(xelis-he/src/tx/builder.rs:194, tx/verify.rs:267).  A C++
implementation in hashcore/csrc is preferred at runtime; this module is the
exact fallback, implementing the full chunked Merkle tree so arbitrarily
large transactions hash correctly.
"""

from __future__ import annotations

_IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

_MSG_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

_BLOCK_LEN = 64
_CHUNK_LEN = 1024
_MASK = 0xFFFFFFFF


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & _MASK


def _g(st, a, b, c, d, mx, my):
    st[a] = (st[a] + st[b] + mx) & _MASK
    st[d] = _rotr(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _MASK
    st[b] = _rotr(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b] + my) & _MASK
    st[d] = _rotr(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _MASK
    st[b] = _rotr(st[b] ^ st[c], 7)


def _compress(cv, block_words, counter, block_len, flags):
    st = list(cv) + list(_IV[:4]) + [
        counter & _MASK, (counter >> 32) & _MASK, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(st, 0, 4, 8, 12, m[0], m[1])
        _g(st, 1, 5, 9, 13, m[2], m[3])
        _g(st, 2, 6, 10, 14, m[4], m[5])
        _g(st, 3, 7, 11, 15, m[6], m[7])
        _g(st, 0, 5, 10, 15, m[8], m[9])
        _g(st, 1, 6, 11, 12, m[10], m[11])
        _g(st, 2, 7, 8, 13, m[12], m[13])
        _g(st, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[i] for i in _MSG_PERM]
    for i in range(8):
        st[i] ^= st[i + 8]
        st[i + 8] ^= cv[i]
    return st


def _words(b: bytes) -> list[int]:
    return [int.from_bytes(b[i:i + 4], "little") for i in range(0, len(b), 4)]


def _chunk_cv(chunk: bytes, chunk_counter: int) -> list[int]:
    cv = list(_IV)
    blocks = [chunk[i:i + _BLOCK_LEN] for i in range(0, max(len(chunk), 1), _BLOCK_LEN)]
    for i, block in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == len(blocks) - 1:
            flags |= CHUNK_END
        padded = block + b"\x00" * (_BLOCK_LEN - len(block))
        cv = _compress(cv, _words(padded), chunk_counter, len(block), flags)[:8]
    return cv


def _root_output(cv, block_words, counter, block_len, flags, out_len: int) -> bytes:
    out = bytearray()
    output_counter = 0
    while len(out) < out_len:
        st = _compress(cv, block_words, output_counter, block_len, flags | ROOT)
        for w in st:
            out += w.to_bytes(4, "little")
        output_counter += 1
    return bytes(out[:out_len])


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """Unkeyed BLAKE3 hash of ``data``.  Prefers the C++ kernel."""
    if out_len == 32 and _native_blake3 is not None:
        return _native_blake3(data)
    return _blake3_py(data, out_len)


def _blake3_py(data: bytes, out_len: int = 32) -> bytes:
    if len(data) <= _CHUNK_LEN:
        # single chunk: root is the chunk itself
        chunk = data
        blocks = [chunk[i:i + _BLOCK_LEN] for i in range(0, max(len(chunk), 1), _BLOCK_LEN)]
        cv = list(_IV)
        for i, block in enumerate(blocks[:-1]):
            flags = CHUNK_START if i == 0 else 0
            cv = _compress(cv, _words(block), 0, _BLOCK_LEN, flags)[:8]
        last = blocks[-1]
        flags = CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
        padded = last + b"\x00" * (_BLOCK_LEN - len(last))
        return _root_output(cv, _words(padded), 0, len(last), flags, out_len)

    # multi-chunk: build the binary tree
    chunks = [data[i:i + _CHUNK_LEN] for i in range(0, len(data), _CHUNK_LEN)]
    cvs = [_chunk_cv(c, i) for i, c in enumerate(chunks)]

    def merge(nodes: list[list[int]], is_root: bool) -> bytes | list[int]:
        if len(nodes) == 1:
            raise AssertionError("merge requires >= 2 nodes")
        # left subtree gets the largest power of two strictly less than len
        n = len(nodes)
        split = 1
        while split * 2 < n:
            split *= 2
        left = nodes[:split] if split > 1 else nodes[0]
        right = nodes[split:]
        left_cv = merge(nodes[:split], False) if split > 1 else nodes[0]
        right_cv = merge(right, False) if len(right) > 1 else right[0]
        block_words = list(left_cv) + list(right_cv)
        if is_root:
            return _root_output(list(_IV), block_words, 0, _BLOCK_LEN, PARENT, out_len)
        return _compress(list(_IV), block_words, 0, _BLOCK_LEN, PARENT)[:8]

    return merge(cvs, True)  # type: ignore[return-value]


try:  # native C++ kernel (csrc); optional
    from .native import blake3 as _native_blake3
except Exception:  # pragma: no cover
    _native_blake3 = None
