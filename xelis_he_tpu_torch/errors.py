"""Typed error hierarchy, mirroring the reference's error enums
(xelis-he/src/lib.rs:48-89, tx/builder.rs:33-37, tx/verify.rs:16-21)."""

from __future__ import annotations


class XelisError(Exception):
    """Base class for all framework errors."""


class DecompressionError(XelisError):
    """Point decompression failed (compressed.rs:13-15)."""


class CipherFormatError(XelisError):
    """Malformed ciphertext (lib.rs:48-50)."""


class ExtraDataDecryptionError(XelisError):
    """Transfer extra-data decryption error (lib.rs:52-57)."""


class TranscriptError(XelisError):
    """Identity point appended to transcript (transcript.rs:6-10)."""


class ProofGenerationError(XelisError):
    """Proof generation failed (lib.rs:59-69)."""


class InsufficientFundsError(ProofGenerationError):
    """Not enough funds in the account (lib.rs:63-64)."""


class FormatError(ProofGenerationError):
    """Invalid structural format (lib.rs:67-68 / 87-88)."""


class ProofVerificationError(XelisError):
    """Proof verification failed (lib.rs:71-89).  ``kind`` mirrors the
    reference's enum variants: signature, decompression, commitment_eq_proof,
    ciphertext_validity_proof, generic_proof, range_proof, transcript, format.
    """

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        super().__init__(f"proof verification failed: {kind}" + (f" ({detail})" if detail else ""))


class InvalidNonceError(XelisError):
    """Transaction nonce does not match account nonce (verify.rs:18-19)."""


class StateError(XelisError):
    """Error propagated from the caller's blockchain state implementation."""

    def __init__(self, inner):
        self.inner = inner
        super().__init__(f"state error: {inner!r}")
