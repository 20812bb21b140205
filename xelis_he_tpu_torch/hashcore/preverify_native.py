"""ctypes loader/builder for the native block pre-verification engine
(csrc/preverify.cpp -> libxhepreverify.so).

Same build pattern as verifyfold_native.py.  Import failure is non-fatal:
the batched verifier falls back to the per-tx fold-script path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent / "csrc"
_SRC = _DIR / "preverify.cpp"
_DEPS = [
    _DIR / "verifyfold.cpp",
    _DIR / "hashcore.cpp",
    _DIR / "keccak_unrolled.inc",
    _DIR / "scalarops.cpp",
    _DIR / "curve25519.cpp",
]
_LIB = _DIR / "libxhepreverify.so"

# rc codes (preverify.cpp)
RC_OK = 0
RC_IDENTITY = 1
RC_MALFORMED = 2
RC_UNSUPPORTED = 3
RC_RANGE_STRUCT = 4
RC_NONCANONICAL = 5
RC_STATE_REF = 6
RC_STATE_DECOMP = 7
RC_NONCE = 8
RC_COMMASSETS = 9
RC_MSIG = 10


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
_i64 = ctypes.c_int64

lib.xhe_blk_new.argtypes = [_sz, _sz]  # expect_txs, max_party
lib.xhe_blk_new.restype = _vp

lib.xhe_blk_free.argtypes = [_vp]
lib.xhe_blk_free.restype = None

lib.xhe_blk_collect.argtypes = [
    _vp,       # session
    _vp,       # wire blob
    _vp, _sz,  # uint64 offsets (n+1), n
    _vp,       # int32 lane_counts (n, 3)
    _vp,       # int32 rcs (n,)
]
lib.xhe_blk_collect.restype = ctypes.c_int

lib.xhe_blk_nrows.argtypes = [_vp]
lib.xhe_blk_nrows.restype = _sz

lib.xhe_blk_encodings.argtypes = [_vp, _vp]
lib.xhe_blk_encodings.restype = None

lib.xhe_blk_fold_group.argtypes = [
    _vp,       # session
    _sz, _sz,  # tx_lo, n
    _vp, _vp,  # state blob, uint64 offsets (n+1)
    _vp,       # rand64 blob
    _i64,      # extra_base
    _vp, _vp,  # sigma_sc, sigma_rows
    _vp, _vp,  # range_sc, range_rows
    _vp, _vp, _vp,  # sig_s, sig_e_neg, sig_rows
    _vp, _vp,  # g_lane, h_lane
    _vp, _vp,  # b_acc, bb_acc
    _vp, _vp,  # g_sc, h_sc
    _vp, _i64, _sz, _vp,  # unk_coords, unk_base, unk_cap, n_unk_out
    _vp,       # int32 rcs
]
lib.xhe_blk_fold_group.restype = ctypes.c_int

lib.xhe_blk_sig_check.argtypes = [_vp, _sz, _sz, _vp, _vp]
lib.xhe_blk_sig_check.restype = ctypes.c_int

# ---- bulk state pass -------------------------------------------------

lib.xhe_blk_state_schema.argtypes = [_vp, _vp, _vp]  # n_accounts*, n_pairs*
lib.xhe_blk_state_schema.restype = ctypes.c_int

lib.xhe_blk_state_tables.argtypes = [
    _vp,  # session
    _vp,  # uint32 acct_off (n_accounts,)
    _vp,  # uint8 acct_sender (n_accounts,)
    _vp,  # int32 pair_acct (n_pairs,)
    _vp,  # uint32 pair_asset_off (n_pairs,)
    _vp,  # uint8 pair_role (n_pairs,)
]
lib.xhe_blk_state_tables.restype = None

lib.xhe_blk_state_run.argtypes = [
    _vp,       # session
    _vp,       # uint64 nonces (n_accounts,)
    _vp, _vp,  # init blob, uint64 offsets (n_pairs+1)
    _vp, _vp,  # multisig-config blob, uint64 offsets (n_accounts+1)
    _i64, _sz,  # extra_base, n_extras
    _vp, _sz, _vp,  # unk_coords, unk_cap, int32 n_unk_out*
    _vp, _vp,  # int32 term_counts, int32 draw_counts (n_txs each)
    _vp,       # int32 sig_counts (n_txs,): 1 + checked multisig lanes
    _vp, _vp,  # int32 first_bad*, uint64 bad_aux*
]
lib.xhe_blk_state_run.restype = ctypes.c_int

lib.xhe_blk_ms_sizes.argtypes = [
    _vp,
    _vp, _vp, _vp,  # uint8 changed, uint8 thr, int32 nsg (n_accounts each)
]
lib.xhe_blk_ms_sizes.restype = ctypes.c_int  # total changed signer slots

lib.xhe_blk_ms_emit.argtypes = [_vp, _vp]  # uint32 signer wire offsets
lib.xhe_blk_ms_emit.restype = None

lib.xhe_blk_state_sizes.argtypes = [_vp, _vp, _vp]  # int32 c_lens, d_lens
lib.xhe_blk_state_sizes.restype = None

lib.xhe_blk_state_emit.argtypes = [
    _vp,
    _vp, _vp,  # int32 rows, int8 coeffs (sum c+d lens)
    _vp, _vp,  # uint8 gcos (n_pairs, 32), uint8 roles (n_pairs,)
    _vp,       # uint64 nonces_out (n_accounts,)
    _vp,       # uint8 unk_encs_out (n_unk, 32)
]
lib.xhe_blk_state_emit.restype = None
