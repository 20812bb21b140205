"""Inner-product argument (bit-exact with dalek bulletproofs' ipp).

Transcript choreography: ``innerproduct_domain_sep(n)`` then per round
L/R appends (validated on verify) and challenge ``u``
(dalek inner_product_proof.rs; consumed by the reference via
RangeProof::prove_multiple, xelis-he/src/tx/builder.rs:525-533).

TPU-first design note: instead of folding the generator *point* vectors each
round (O(n) scalar-muls per round, as dalek does), the prover tracks the fold
coefficients over the ORIGINAL generators and emits each round's L/R as one
MSM over the original basis.  This keeps all group arithmetic inside `msm()`
— the single primitive the batched numpy/TPU engine accelerates — while
producing byte-identical proofs.
"""

from __future__ import annotations

from .. import scalars
from ..errors import ProofVerificationError
from ..pyref.ristretto import RistrettoPoint, multiscalar_mul
from ..transcript import ProtocolTranscript
from .util import inner_product

try:  # native IPP prover session (one FFI call per round)
    from ..hashcore.prover_native import lib as _prover_lib
except Exception:  # pragma: no cover - native build unavailable
    _prover_lib = None

L = scalars.L

# packed-generator blobs keyed by id(list head): the G/H vectors passed by
# prove_multiple are the BulletproofGens shared lists, so packing happens
# once per (n, m) per process instead of once per transaction.  Guarded by
# _gens_lock: build_batch runs create() from a thread pool, and both the
# check-then-act here and the C++ registry mutation in
# xhe_ipp_gens_register are racy without it (concurrent registration of
# the same basis can corrupt the table slots).
import threading as _ip_threading

_gens_lock = _ip_threading.Lock()
_packed_cache: dict = {}
# per-basis C++ 8-bit Straus table registry ids (built once per process).
# Keyed by blob CONTENT (not id()): _packed_cache.clear() may drop the only
# other reference to a blob, and an id()-keyed entry could then silently
# alias a later, different basis at the same address.  Content keys also
# keep the blobs alive for the lifetime of the registry entry.
_gens_id_cache: dict = {}


def _packed_points(points: list[RistrettoPoint]) -> bytes:
    from ..pyref.ristretto import _pack_pt

    key = (id(points[0]), id(points[-1]), len(points))
    with _gens_lock:
        blob = _packed_cache.get(key)
    if blob is None:
        blob = b"".join(_pack_pt(p) for p in points)
        with _gens_lock:
            if len(_packed_cache) > 64:  # bound growth across odd shapes
                _packed_cache.clear()
            _packed_cache[key] = blob
    return blob


def _gens_registry_id(n: int, gp: bytes, hp: bytes) -> int:
    """Register (once) the 8-bit windowed tables for this generator basis;
    -1 falls back to the in-session Pippenger (large bases, full registry)."""
    key = (gp, hp)
    with _gens_lock:
        gid = _gens_id_cache.get(key)
        if gid is None:
            gid = _prover_lib.xhe_ipp_gens_register(n, gp, hp)
            _gens_id_cache[key] = gid
    return gid


class InnerProductProof:
    __slots__ = ("L_vec", "R_vec", "a", "b")

    def __init__(self, L_vec: list[bytes], R_vec: list[bytes], a: int, b: int):
        self.L_vec = L_vec
        self.R_vec = R_vec
        self.a = a % L
        self.b = b % L

    # -- prover -------------------------------------------------------------

    @staticmethod
    def create(
        transcript: ProtocolTranscript,
        Q: RistrettoPoint,
        G_factors: list[int],
        H_factors: list[int],
        G_vec: list[RistrettoPoint],
        H_vec: list[RistrettoPoint],
        a_vec: list[int],
        b_vec: list[int],
        msm=multiscalar_mul,
    ) -> "InnerProductProof":
        import numpy as np

        n = len(G_vec)
        assert n and (n & (n - 1)) == 0, "n must be a power of two"
        assert len(H_vec) == len(a_vec) == len(b_vec) == len(G_factors) == len(H_factors) == n

        transcript.innerproduct_domain_separator(n)

        lg_n = n.bit_length() - 1

        def _as_sc_bytes(v):
            """(n, 32) scalar blob from either a canonical scalar ARRAY
            (prove_multiple's batched path) or a list of ints."""
            if isinstance(v, np.ndarray):
                return v.tobytes()
            from .. import scalarops

            return scalarops.ints_to_array([x % L for x in v]).tobytes()

        if _prover_lib is not None and n >= 2:
            # native session: generators/coefficients stay resident in C++,
            # Python relays only L/R bytes and challenges (byte-exact)
            import ctypes

            from .. import scalarops
            from ..pyref.ristretto import _pack_pt

            gp = _packed_points(G_vec)
            hp = _packed_points(H_vec)
            handle = _prover_lib.xhe_ipp_new(
                n,
                _gens_registry_id(n, gp, hp),
                gp,
                hp,
                _pack_pt(Q),
                _as_sc_bytes(G_factors),
                _as_sc_bytes(H_factors),
                _as_sc_bytes(a_vec),
                _as_sc_bytes(b_vec),
            )
            if handle:
                try:
                    L_out = []
                    R_out = []
                    Lb = ctypes.create_string_buffer(32)
                    Rb = ctypes.create_string_buffer(32)
                    u_bytes = None
                    for _ in range(lg_n):
                        rc = _prover_lib.xhe_ipp_round(handle, u_bytes, Lb, Rb)
                        if rc != 0:
                            raise ProofVerificationError("format", "ipp round")
                        L_pt, R_pt = bytes(Lb.raw), bytes(Rb.raw)
                        transcript.append_point(b"L", L_pt)
                        transcript.append_point(b"R", R_pt)
                        L_out.append(L_pt)
                        R_out.append(R_pt)
                        u = transcript.challenge_scalar(b"u")
                        u_bytes = scalarops.int_to_bytes32(u)
                    ab = ctypes.create_string_buffer(64)
                    rc = _prover_lib.xhe_ipp_final(
                        handle, u_bytes, ab, ctypes.byref(ab, 32)
                    )
                    if rc != 0:
                        raise ProofVerificationError("format", "ipp final")
                    a0 = int.from_bytes(ab.raw[:32], "little")
                    b0 = int.from_bytes(ab.raw[32:64], "little")
                    return InnerProductProof(L_out, R_out, a0, b0)
                finally:
                    _prover_lib.xhe_ipp_free(handle)

        from .. import scalarops as _so

        def _as_ints(v):
            return _so.array_to_ints(v) if isinstance(v, np.ndarray) else [
                x % L for x in v
            ]

        a = _as_ints(a_vec)
        b = _as_ints(b_vec)
        # Fold coefficients of the current (logical) G'/H' vectors over the
        # original generator basis.  Initialized with the first-round factors
        # (dalek folds G_factors/H_factors into round one).
        wg = _as_ints(G_factors)
        wh = _as_ints(H_factors)

        L_out: list[bytes] = []
        R_out: list[bytes] = []

        n_r = n
        for r in range(lg_n):
            n_r //= 2
            hi_shift = lg_n - 1 - r  # original index i is in the hi half iff this bit is set

            a_L, a_R = a[:n_r], a[n_r:]
            b_L, b_R = b[:n_r], b[n_r:]
            c_L = inner_product(a_L, b_R)
            c_R = inner_product(a_R, b_L)

            # L = <a_L, G'_R> + <b_R, H'_L> + c_L*Q  over the original basis
            sc_L: list[int] = []
            pt_L: list[RistrettoPoint] = []
            sc_R: list[int] = []
            pt_R: list[RistrettoPoint] = []
            for i, g in enumerate(G_vec):
                logical = i & (2 * n_r - 1)  # i mod (2*n_r)
                if (i >> hi_shift) & 1:
                    sc_L.append(a_L[logical - n_r] * wg[i] % L)
                    pt_L.append(g)
                else:
                    sc_R.append(a_R[logical] * wg[i] % L)
                    pt_R.append(g)
            for i, h in enumerate(H_vec):
                logical = i & (2 * n_r - 1)
                if (i >> hi_shift) & 1:
                    sc_R.append(b_L[logical - n_r] * wh[i] % L)
                    pt_R.append(h)
                else:
                    sc_L.append(b_R[logical] * wh[i] % L)
                    pt_L.append(h)
            sc_L.append(c_L)
            pt_L.append(Q)
            sc_R.append(c_R)
            pt_R.append(Q)

            L_pt = msm(sc_L, pt_L).compress()
            R_pt = msm(sc_R, pt_R).compress()
            transcript.append_point(b"L", L_pt)
            transcript.append_point(b"R", R_pt)
            L_out.append(L_pt)
            R_out.append(R_pt)

            u = transcript.challenge_scalar(b"u")
            u_inv = scalars.invert(u)

            a = [(a_L[i] * u + u_inv * a_R[i]) % L for i in range(n_r)]
            b = [(b_L[i] * u_inv + u * b_R[i]) % L for i in range(n_r)]
            # G' fold: lo *= u_inv, hi *= u;  H' fold: lo *= u, hi *= u_inv
            for i in range(n):
                if (i >> hi_shift) & 1:
                    wg[i] = wg[i] * u % L
                    wh[i] = wh[i] * u_inv % L
                else:
                    wg[i] = wg[i] * u_inv % L
                    wh[i] = wh[i] * u % L

        return InnerProductProof(L_out, R_out, a[0], b[0])

    # -- verifier -----------------------------------------------------------

    def verification_scalars(self, n: int, transcript: ProtocolTranscript):
        """Recompute (u_sq, u_inv_sq, s) from the transcript
        (dalek verification_scalars).  u_sq/u_inv_sq are int lists; ``s``
        is an (n, 32)-byte scalar array (built by the C++ batch engine)."""
        from .. import scalarops

        lg_n = len(self.L_vec)
        if n == 0 or lg_n >= 32 or n != (1 << lg_n):
            raise ProofVerificationError("range_proof", "ipp length mismatch")

        transcript.innerproduct_domain_separator(n)

        challenges: list[int] = []
        for L_b, R_b in zip(self.L_vec, self.R_vec):
            transcript.validate_and_append_point(b"L", L_b)
            transcript.validate_and_append_point(b"R", R_b)
            challenges.append(transcript.challenge_scalar(b"u"))

        challenges_inv = scalarops.array_to_ints(scalarops.batch_invert(challenges))
        u_sq = [u * u % L for u in challenges]
        u_inv_sq = [u * u % L for u in challenges_inv]

        s = scalarops.ipp_s_vector(u_sq, challenges_inv, n)
        return u_sq, u_inv_sq, s

    # -- serialization (ipp part of RangeProof::to_bytes) -------------------

    def to_bytes(self) -> bytes:
        out = b"".join(l + r for l, r in zip(self.L_vec, self.R_vec))
        return out + scalars.to_bytes(self.a) + scalars.to_bytes(self.b)

    @staticmethod
    def from_bytes(data: bytes) -> "InnerProductProof":
        if len(data) < 64 or (len(data) - 64) % 64 != 0:
            raise ProofVerificationError("format", "ipp length")
        rounds = (len(data) - 64) // 64
        L_vec = [data[64 * i: 64 * i + 32] for i in range(rounds)]
        R_vec = [data[64 * i + 32: 64 * i + 64] for i in range(rounds)]
        a = scalars.from_canonical_bytes(data[-64:-32])
        b = scalars.from_canonical_bytes(data[-32:])
        if a is None or b is None:
            raise ProofVerificationError("format", "non-canonical ipp scalar")
        return InnerProductProof(L_vec, R_vec, a, b)
