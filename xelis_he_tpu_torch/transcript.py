"""Protocol transcript: typed appends + domain separators over merlin.

Bit-exact mirror of xelis-he/src/transcript.rs: scalar/point/pubkey/
ciphertext/commitment/handle/hash appends, 64-byte wide challenge scalars,
identity-rejecting ``validate_and_append_point``, and the six domain
separators.
"""

from __future__ import annotations

from . import scalars
from .errors import TranscriptError
from .hashcore.merlin import Transcript
from .types import CompressedCiphertext, CompressedCommitment, CompressedHandle, CompressedPubkey, Hash

_IDENTITY_BYTES = b"\x00" * 32


class ProtocolTranscript(Transcript):
    """merlin Transcript with the reference's protocol extensions."""

    # -- typed appends (transcript.rs:38-71) --------------------------------

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.append_message(label, scalars.to_bytes(scalar))

    def append_point(self, label: bytes, point_bytes: bytes) -> None:
        assert len(point_bytes) == 32
        self.append_message(label, point_bytes)

    def append_pubkey(self, label: bytes, pubkey: CompressedPubkey) -> None:
        self.append_message(label, pubkey.data)

    def append_ciphertext(self, label: bytes, ct: CompressedCiphertext) -> None:
        self.append_message(label, ct.data)

    def append_commitment(self, label: bytes, commitment: CompressedCommitment) -> None:
        self.append_message(label, commitment.data)

    def append_handle(self, label: bytes, handle: CompressedHandle) -> None:
        self.append_message(label, handle.data)

    def append_hash(self, label: bytes, h: Hash) -> None:
        self.append_message(label, h.data)

    def challenge_scalar(self, label: bytes) -> int:
        return scalars.from_bytes_mod_order_wide(self.challenge_bytes(label, 64))

    def validate_and_append_point(self, label: bytes, point_bytes: bytes) -> None:
        """Reject the identity encoding (transcript.rs:73-84)."""
        if point_bytes == _IDENTITY_BYTES:
            raise TranscriptError("point should not be the identity")
        self.append_message(label, point_bytes)

    # -- domain separators (transcript.rs:86-111) ---------------------------

    def new_commitment_eq_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"new-commitment-proof")

    def transfer_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"transfer-proof")

    def burn_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"burn-proof")

    def multisig_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"multisig-proof")

    def equality_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"equality-proof")

    def ciphertext_validity_proof_domain_separator(self) -> None:
        self.append_message(b"dom-sep", b"validity-proof")

    # -- bulletproofs domain separators (dalek bulletproofs transcript) -----

    def rangeproof_domain_separator(self, n: int, m: int) -> None:
        self.append_message(b"dom-sep", b"rangeproof v1")
        self.append_u64(b"n", n)
        self.append_u64(b"m", m)

    def innerproduct_domain_separator(self, n: int) -> None:
        self.append_message(b"dom-sep", b"ipp v1")
        self.append_u64(b"n", n)
