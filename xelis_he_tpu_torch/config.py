"""Protocol constants (frozen) and runtime tunables.

The reference pins its protocol parameters as scattered compile-time
constants (SURVEY.md §5 config notes); here they live in one typed, frozen
module.  PROTOCOL values are consensus-critical — changing any of them
breaks proof/transcript compatibility.  TUNING values only affect
performance.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ProtocolConstants:
    # Bulletproofs generator capacity: 64-bit ranges, up to 512 aggregated
    # commitments per proof (proofs.rs:20)
    RANGE_BITS: int = 64
    BP_PARTY_CAPACITY: int = 512

    # transcript labels (transcript.rs:86-111, verify.rs:152)
    TX_TRANSCRIPT_LABEL: bytes = b"transaction-proof"

    # extra-data AE nonce; safe because every transfer derives a one-time
    # key (extra_data.rs:18-22)
    AE_NONCE: bytes = b"xelis-crypto"

    # the native asset is the all-zero hash (lib.rs:43-45); fees apply to
    # the native asset only (builder.rs:264-267, verify.rs:114-117)
    NATIVE_ASSET_BYTES: bytes = b"\x00" * 32

    # wire format version for tx/wire.py
    WIRE_VERSION: int = 1


@dataclass
class TuningConstants:
    """Performance knobs — safe to change per deployment."""

    # MSM lanes below this go to the host Pippenger instead of the device
    ACCEL_MIN_MSM_SIZE: int = 16
    # scalar window for the Pippenger device path
    MSM_WINDOW_BITS: int = 13
    # ECDLP default table size (baby-step bits); 2^26 covers 48-bit amounts
    # with ~2^22 giant steps
    ECDLP_L1: int = 26


PROTOCOL = ProtocolConstants()
TUNING = TuningConstants()
