"""Per-transfer encrypted payloads (memo data), decryptable by sender AND
receiver.  Mirrors xelis-he/src/extra_data.rs exactly:

- fresh opening r; shared key = SHA3-256(compress(r*H)) (extra_data.rs:50-60)
- handles r*P_sender / r*P_receiver; decrypt side derives the same key as
  SHA3-256(compress(s*D)) since s*D = s*r*s^-1*H = r*H (extra_data.rs:63-68)
- cipher = ChaCha20 with the fixed nonce b"xelis-crypto" (one-time keys make
  nonce reuse safe; extra_data.rs:18-22)
- wire form: cipher || sender_handle || receiver_handle (extra_data.rs:92-98)
"""

from __future__ import annotations

import hashlib

from .elgamal import DecryptHandle, ElGamalPubkey, ElGamalSecretKey, H, PedersenOpening
from .errors import CipherFormatError
from .hashcore.chacha20 import chacha20_xor
from .types import CompressedHandle, Role

NONCE = b"xelis-crypto"
assert len(NONCE) == 12


def derive_shared_key(point_bytes: bytes) -> bytes:
    return hashlib.sha3_256(point_bytes).digest()


def derive_shared_key_from_opening(opening: PedersenOpening) -> bytes:
    return derive_shared_key((opening.scalar * H).compress())


def derive_shared_key_from_handle(sk: ElGamalSecretKey, handle: DecryptHandle) -> bytes:
    return derive_shared_key((sk.scalar * handle.point).compress())


class PlaintextData:
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = bytes(data)

    def encrypt_in_place(self, key: bytes) -> "AeCipher":
        return AeCipher(chacha20_xor(key, NONCE, self.data))

    def __eq__(self, other):
        return isinstance(other, PlaintextData) and self.data == other.data


class AeCipher:
    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = bytes(data)


class ExtraData:
    __slots__ = ("cipher", "sender_handle", "receiver_handle")

    def __init__(self, cipher: AeCipher, sender_handle: CompressedHandle, receiver_handle: CompressedHandle):
        self.cipher = cipher
        self.sender_handle = sender_handle
        self.receiver_handle = receiver_handle

    @staticmethod
    def new(data: PlaintextData, sender: ElGamalPubkey, receiver: ElGamalPubkey) -> "ExtraData":
        opening = PedersenOpening.generate_new()
        key = derive_shared_key_from_opening(opening)
        return ExtraData(
            data.encrypt_in_place(key),
            sender.decrypt_handle(opening).compress(),
            receiver.decrypt_handle(opening).compress(),
        )

    def to_bytes(self) -> bytes:
        return self.cipher.data + self.sender_handle.data + self.receiver_handle.data

    def decrypt(self, sk: ElGamalSecretKey, role: Role) -> PlaintextData:
        handle = self.receiver_handle if role == Role.RECEIVER else self.sender_handle
        try:
            h = handle.decompress()
        except Exception as exc:
            raise CipherFormatError from exc
        key = derive_shared_key_from_handle(sk, h)
        return PlaintextData(chacha20_xor(key, NONCE, self.cipher.data))
