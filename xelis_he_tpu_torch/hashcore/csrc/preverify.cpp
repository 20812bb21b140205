// Native block pre-verification engine: whole-transaction parsing,
// Fiat-Shamir transcript construction, sigma/range-proof batch folds and
// MSM lane emission for a FULL BLOCK of transactions, in a handful of FFI
// calls.
//
// Rationale: after round 3 the binding constraint on batched verification
// was the ~84 us/tx of *Python* pre_verify bookkeeping (transcript append
// buffering, per-lane plan lists, per-proof script assembly) — see
// PERF_NOTES.md.  This engine subsumes all of it: the caller passes each
// transaction's canonical wire bytes (tx/wire.py format) plus a tiny
// per-tx state descriptor (the homomorphic balance terms, which only the
// caller's ledger knows), and the engine emits, per chunk of txs:
//
//   - the sigma mega-MSM lanes: (scalar, device-row) pairs, in final lane
//     order (no Python resolution step),
//   - the range-proof mega-MSM lanes likewise,
//   - the Schnorr batch lanes (s, -e, pubkey row) per signature,
//   - the shared G/H scalar accumulators and the Bulletproofs
//     per-generator g/h lane accumulators (b/bb included),
//
// byte-exact with the Python path (same STROBE ops, same challenge
// choreography — mirrors xelis-he/src/tx/verify.rs:201-485 and
// proofs.rs; the per-proof folds reuse xhe_eq_fold / xhe_validity_fold /
// xhe_bp_fold from verifyfold.cpp).
//
// The engine also owns the block's encoding->device-row intern map
// (replacing tx/verify.py _collect_compressed): the collect pass parses
// every tx once, interns each 32-byte encoding in first-seen order
// (identity first, row 0), and caches per-tx descriptors so the fold pass
// never re-parses.  Fold calls on disjoint tx ranges are read-only on the
// session and safe to run concurrently from a thread pool.
//
// Transactions with multisig signatures or contract payloads are flagged
// unsupported at collect time; the caller routes those blocks down the
// Python path (same behavior, slower).

#include "verifyfold.cpp"
#include "curve25519.cpp"  // xhe_pt_decompress for out-of-block state terms

#include <vector>

namespace {

constexpr uint32_t NO_ROW = 0x7fffffff;

struct Intern {
  std::vector<uint8_t> arena;   // 32 bytes per interned encoding
  std::vector<uint32_t> slots;  // open addressing, 0xffffffff = empty
  size_t mask = 0;

  void reserve(size_t expect) {
    size_t cap = 64;
    while (cap < expect * 2) cap <<= 1;
    slots.assign(cap, 0xffffffffu);
    mask = cap - 1;
    arena.reserve(expect * 32);
  }

  static uint64_t hash(const uint8_t *p) {
    uint64_t a, b, c, d;
    std::memcpy(&a, p, 8);
    std::memcpy(&b, p + 8, 8);
    std::memcpy(&c, p + 16, 8);
    std::memcpy(&d, p + 24, 8);
    uint64_t h = a * 0x9e3779b97f4a7c15ULL;
    h ^= (b >> 13) + b * 0xc2b2ae3d27d4eb4fULL;
    h ^= (c << 7) + c * 0x165667b19e3779f9ULL;
    h ^= d + (h >> 29);
    return h * 0xff51afd7ed558ccdULL;
  }

  uint32_t row_count() const { return (uint32_t)(arena.size() / 32); }

  // lookup-or-insert (collect pass only; single-threaded)
  uint32_t put(const uint8_t *enc) {
    size_t i = hash(enc) & mask;
    for (;;) {
      uint32_t r = slots[i];
      if (r == 0xffffffffu) {
        uint32_t row = row_count();
        arena.insert(arena.end(), enc, enc + 32);
        slots[i] = row;
        if ((size_t)(row + 1) * 2 > mask) grow();
        return row;
      }
      if (!std::memcmp(&arena[(size_t)r * 32], enc, 32)) return r;
      i = (i + 1) & mask;
    }
  }

  void grow() {
    size_t cap = (mask + 1) * 2;
    std::vector<uint32_t> ns(cap, 0xffffffffu);
    size_t nm = cap - 1;
    for (uint32_t r = 0; r < row_count(); ++r) {
      size_t i = hash(&arena[(size_t)r * 32]) & nm;
      while (ns[i] != 0xffffffffu) i = (i + 1) & nm;
      ns[i] = r;
    }
    slots.swap(ns);
    mask = nm;
  }

  // read-only lookup (fold pass; thread-safe)
  uint32_t get(const uint8_t *enc) const {
    size_t i = hash(enc) & mask;
    for (;;) {
      uint32_t r = slots[i];
      if (r == 0xffffffffu) return NO_ROW;
      if (!std::memcmp(&arena[(size_t)r * 32], enc, 32)) return r;
      i = (i + 1) & mask;
    }
  }
};

struct TransferD {
  uint32_t asset_off, dest_off, commit_off, sh_off, rh_off, proof_off;
  int32_t dest_row, commit_row, sh_row, rh_row, y0, y1, y2;
};

struct CommD {
  uint32_t asset_off, commit_off, proof_off;
  int32_t commit_row, y0, y1, y2;
};

struct TxD {
  // kind: 0 transfers, 1 burn, 2 call-contract, 3 deploy, 4 multisig
  // payload (tx/wire.py _KIND_*)
  uint8_t version, kind;
  uint64_t fee, nonce;
  uint32_t src_off;
  int32_t src_row;
  uint32_t n_transfers, n_comms, tr0, cm0;
  uint32_t burn_off;  // asset offset (kind 1)
  uint64_t burn_amount;
  uint32_t ca0 = 0, n_call = 0;        // kind 2: call-asset range
  uint8_t ms_threshold = 0;            // kind 4: payload config
  uint32_t ms_sg0 = 0, ms_n_signers = 0;
  uint32_t msig0 = 0, n_msigs = 0;     // carried multisig signatures
  uint32_t rp_off, lg, m_real, m_padded, rp_rows0;
  uint32_t sig_off;
  uint32_t pre_off, pre_len;
  uint32_t ms_pre_len;  // preimage prefix multisig cosigners sign (blake3)
  uint32_t sig_lane0 = 0;  // global signature-lane base (1 + checked msigs)
  uint32_t sigma_base, range_lanes;
  u64 e_red[4];  // signature e reduced mod L (for the final hash check)
};

struct CallAsset {  // kind-2 (asset, amount) entry
  uint32_t asset_off;
  uint64_t amount;
};

struct MsigRec {  // one carried multisig signature (wire order)
  uint8_t id;
  uint32_t sig_off;
  u64 e_red[4];
};

// One CHECKED multisig signature (signer index in range — verify.rs:276
// skips out-of-range indices): everything the fold + final hash check
// need.  pk bytes are copied because initial-config encodings live in a
// caller buffer that does not outlive the state pass.
struct SigCheck {
  uint32_t sig_off;
  int32_t row;
  uint8_t pk[32];
  u64 e_red[4];
};

// Per-account multisig config during the sequential state replay
// (verify.rs:258-292 reads it, :420-426 mutates it).
struct MsCfg {
  bool present = false;
  uint8_t threshold = 0;
  std::vector<int32_t> rows;      // signer device rows
  std::vector<uint8_t> enc;       // 32B per signer
  std::vector<uint32_t> woffs;    // wire offsets (in-block configs only)
  bool from_wire = false;         // set by an in-block payload
};

// Bulk state pass (round 4): per-(account, asset) running balance term
// vectors.  Homomorphic updates only APPEND terms (sender spends append
// negated transfer rows, receiver credits append positive rows), so the
// balance snapshot a commitment-eq proof needs is always a PREFIX of the
// pair's vector — hot accounts stay O(1) per touch and snapshots are
// {pair, c_len, d_len, g} quadruples, never copies.
struct PairState {
  std::vector<int32_t> c_rows, d_rows;  // commitment / handle term rows
  std::vector<int8_t> c_coef, d_coef;   // +-1 each
  u64 g[4] = {0, 0, 0, 0};              // commitment G coefficient mod L
  uint8_t last_role = 0;                // 0 sender, 1 receiver (last touch)
};

struct CommSnap {  // per (tx, commitment) balance snapshot
  int32_t pair = -1;
  uint32_t c_len = 0, d_len = 0;
  u64 g[4] = {0, 0, 0, 0};
};

// open-addressing (acct_id, asset_id) -> pair_id map, sized once (pair
// count is bounded by total commitments + transfers; no grow path)
struct PairMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  size_t mask = 0;

  void reserve(size_t expect) {
    size_t cap = 64;
    while (cap < (expect + 1) * 2) cap <<= 1;
    keys.assign(cap, ~0ull);
    vals.assign(cap, -1);
    mask = cap - 1;
  }
  int32_t get_or_add(uint64_t key, int32_t next_id) {
    size_t i = (key * 0x9e3779b97f4a7c15ULL ^ (key >> 29)) & mask;
    for (;;) {
      if (keys[i] == ~0ull) {
        keys[i] = key;
        vals[i] = next_id;
        return -next_id - 1;  // negative: newly added
      }
      if (keys[i] == key) return vals[i];
      i = (i + 1) & mask;
    }
  }
};

struct BlockSession {
  Intern intern;
  const uint8_t *wire = nullptr;
  std::vector<TxD> txs;
  std::vector<TransferD> transfers;
  std::vector<CommD> comms;
  std::vector<CallAsset> call_assets;   // kind-2 payload entries
  std::vector<uint32_t> ms_signer_offs; // kind-4 payload signer wire offs
  std::vector<int32_t> ms_signer_rows;  // interned rows for the same
  std::vector<MsigRec> msig_recs;       // carried multisig signatures
  std::vector<int32_t> rp_rows;   // A,S,T1,T2,L...,R... rows per tx
  std::vector<uint8_t> preimage;  // signing-preimage arena
  size_t max_party = 0;
  Strobe tmpl;  // merlin("Merlin v1.0") + dom-sep "transaction-proof"

  // ---- bulk state pass (schema built by xhe_blk_state_schema) ----
  bool bulk = false;
  Intern acct_in, asset_in;            // 32-byte pubkey / asset interning
  std::vector<uint32_t> acct_off;      // wire offset of first occurrence
  std::vector<uint8_t> acct_sender;    // account ever appears as a source
  std::vector<uint32_t> asset_woff;    // wire offset per asset id
  PairMap pair_map;
  std::vector<int32_t> pair_acct, pair_asset;
  std::vector<uint8_t> pair_role;      // first-touch role (0 snd, 1 rcv)
  std::vector<int32_t> tx_acct;        // per tx: source account id
  std::vector<int32_t> comm_pair;      // per global commitment: pair id
  std::vector<int32_t> transfer_pair;  // per global transfer: pair id
  // filled by xhe_blk_state_run
  std::vector<PairState> pstates;
  std::vector<CommSnap> snaps;  // indexed by global commitment index
  std::vector<uint64_t> nonces;
  std::vector<uint8_t> unk_encs;  // 32B per out-of-block state encoding
  // multisig replay (bulk mode only)
  std::vector<MsCfg> mscfgs;      // per account, mutated in tx order
  std::vector<uint8_t> ms_changed;
  std::vector<SigCheck> sig_checks;     // concatenated checked msig sigs
  std::vector<uint32_t> tx_sig0, tx_nsig;  // per-tx range into sig_checks
  std::vector<uint8_t> ms_hash;   // 32B blake3 message per tx (if checked)
};

struct Rd {
  const uint8_t *p, *end;
  bool fail = false;
  const uint8_t *base;

  const uint8_t *take(size_t n) {
    if ((size_t)(end - p) < n) {
      fail = true;
      return nullptr;
    }
    const uint8_t *out = p;
    p += n;
    return out;
  }
  uint8_t u8() {
    const uint8_t *b = take(1);
    return b ? *b : 0;
  }
  uint16_t u16() {
    const uint8_t *b = take(2);
    uint16_t v = 0;
    if (b) std::memcpy(&v, b, 2);
    return v;
  }
  uint32_t u32() {
    const uint8_t *b = take(4);
    uint32_t v = 0;
    if (b) std::memcpy(&v, b, 4);
    return v;
  }
  uint64_t u64v() {
    const uint8_t *b = take(8);
    uint64_t v = 0;
    if (b) std::memcpy(&v, b, 8);
    return v;
  }
  uint32_t off(const uint8_t *q) const { return (uint32_t)(q - base); }
};

inline bool canonical32(const uint8_t *p) {
  u64 v[4];
  load(p, v);
  return !geq_L(v);
}

inline void be64(uint64_t v, uint8_t out[8]) {
  for (int i = 0; i < 8; ++i) out[i] = (uint8_t)(v >> (8 * (7 - i)));
}

// reduce a 32-byte little-endian value mod L (Signature.from_bytes uses
// plain ints mod L, not canonical rejection)
inline void reduce32(const uint8_t *p, u64 out[4]) {
  u64 v[4], t[4];
  u64 one[4] = {1, 0, 0, 0};
  load(p, v);
  mont_mul(v, R2m, t);
  mont_mul(t, one, out);
}

inline uint32_t next_pow2_u32(uint32_t n) {
  if (n <= 1) return 1;
  uint32_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// rc codes for collect/fold, mirrored in preverify_native.py
enum {
  RC_OK = 0,
  RC_IDENTITY = 1,   // identity point appended (TranscriptError)
  RC_MALFORMED = 2,  // truncated / malformed wire bytes
  RC_UNSUPPORTED = 3,  // multisig / contract payload: use the Python path
  RC_RANGE_STRUCT = 4,  // range-proof structural mismatch
  RC_NONCANONICAL = 5,  // non-canonical proof scalar
  RC_STATE_REF = 6,     // state term overflow (unk_cap exceeded)
  RC_STATE_DECOMP = 7,  // invalid state term encoding (DecompressionError)
  RC_NONCE = 8,         // nonce mismatch (InvalidNonceError)
  RC_COMMASSETS = 9,    // commitment-assets check failed (format error)
  RC_MSIG = 10,         // multisig config/signature-set mismatch (format)
};

}  // namespace

extern "C" {

BlockSession *xhe_blk_new(size_t expect_txs, size_t max_party) {
  auto *s = new BlockSession();
  s->intern.reserve(expect_txs * 20 + 64);
  s->txs.reserve(expect_txs);
  s->max_party = max_party;
  // identity first: dud/padding lanes and zero encodings resolve to row 0
  uint8_t zero[32] = {0};
  s->intern.put(zero);
  // merlin transcript template (builder.prepare_transcript semantics)
  Strobe *t = xhe_strobe_new((const uint8_t *)"Merlin v1.0", 11);
  t_append(t, "dom-sep", 7, (const uint8_t *)"transaction-proof", 17);
  s->tmpl = *t;
  xhe_strobe_free(t);
  return s;
}

void xhe_blk_free(BlockSession *s) { delete s; }

// Collect pass: parse + intern one transaction's wire bytes (tx/wire.py
// format).  Fills the per-tx descriptor cache and the signing preimage.
// Returns an RC code; lane_counts receives {sigma_base, range_lanes,
// m_padded} for the tx (valid only on RC_OK).
static int collect_one(BlockSession *s, const uint8_t *wire, size_t lo,
                       size_t hi, int32_t *lane_counts) {
  Rd r{wire + lo, wire + hi, false, wire};
  TxD tx{};
  if (r.u8() != 1) return RC_MALFORMED;  // wire version
  tx.version = r.u8();
  const uint8_t *src = r.take(32);
  if (!src) return RC_MALFORMED;
  tx.src_off = r.off(src);
  tx.fee = r.u64v();
  tx.nonce = r.u64v();

  std::vector<uint8_t> &pre = s->preimage;
  tx.pre_off = (uint32_t)pre.size();
  pre.push_back(tx.version);
  pre.insert(pre.end(), src, src + 32);
  uint8_t b8[8];
  be64(tx.fee, b8);
  pre.insert(pre.end(), b8, b8 + 8);
  be64(tx.nonce, b8);
  pre.insert(pre.end(), b8, b8 + 8);

  uint8_t kind = r.u8();
  tx.tr0 = (uint32_t)s->transfers.size();
  tx.cm0 = (uint32_t)s->comms.size();
  if (kind == 0) {  // transfers
    tx.kind = 0;
    uint32_t n = r.u16();
    tx.n_transfers = n;
    for (uint32_t i = 0; i < n; ++i) {
      TransferD t{};
      const uint8_t *asset = r.take(32);
      const uint8_t *dest = r.take(32);
      const uint8_t *commit = r.take(32);
      const uint8_t *sh = r.take(32);
      const uint8_t *rh = r.take(32);
      if (r.fail) return RC_MALFORMED;
      const uint8_t *extra = nullptr;
      uint32_t extra_len = 0;
      if (r.u8()) {
        uint32_t clen = r.u32();
        const uint8_t *cipher = r.take(clen);
        const uint8_t *eh = r.take(64);
        if (r.fail) return RC_MALFORMED;
        extra = cipher;
        extra_len = clen + 64;
        (void)eh;
      }
      const uint8_t *proof = r.take(160);
      if (r.fail) return RC_MALFORMED;
      if (!canonical32(proof + 96) || !canonical32(proof + 128))
        return RC_NONCANONICAL;
      t.asset_off = r.off(asset);
      t.dest_off = r.off(dest);
      t.commit_off = r.off(commit);
      t.sh_off = r.off(sh);
      t.rh_off = r.off(rh);
      t.proof_off = r.off(proof);
      t.dest_row = (int32_t)s->intern.put(dest);
      t.commit_row = (int32_t)s->intern.put(commit);
      t.sh_row = (int32_t)s->intern.put(sh);
      t.rh_row = (int32_t)s->intern.put(rh);
      t.y0 = (int32_t)s->intern.put(proof);
      t.y1 = (int32_t)s->intern.put(proof + 32);
      t.y2 = (int32_t)s->intern.put(proof + 64);
      s->transfers.push_back(t);
      pre.insert(pre.end(), asset, asset + 32);
      pre.insert(pre.end(), dest, dest + 32);
      pre.insert(pre.end(), commit, commit + 32);
      pre.insert(pre.end(), sh, sh + 32);
      pre.insert(pre.end(), rh, rh + 32);
      if (extra) pre.insert(pre.end(), extra, extra + extra_len);
      pre.insert(pre.end(), proof, proof + 160);
    }
  } else if (kind == 1) {  // burn
    tx.kind = 1;
    const uint8_t *asset = r.take(32);
    if (!asset) return RC_MALFORMED;
    tx.burn_off = r.off(asset);
    tx.burn_amount = r.u64v();
    pre.insert(pre.end(), asset, asset + 32);
    be64(tx.burn_amount, b8);
    pre.insert(pre.end(), b8, b8 + 8);
  } else if (kind == 2) {  // call contract (tx/wire.py _KIND_CALL)
    tx.kind = 2;
    const uint8_t *contract = r.take(32);
    if (!contract) return RC_MALFORMED;
    pre.insert(pre.end(), contract, contract + 32);
    uint32_t na = r.u16();
    tx.ca0 = (uint32_t)s->call_assets.size();
    tx.n_call = na;
    for (uint32_t i = 0; i < na; ++i) {
      const uint8_t *asset = r.take(32);
      if (!asset) return RC_MALFORMED;
      uint64_t amount = r.u64v();
      s->call_assets.push_back({r.off(asset), amount});
      pre.insert(pre.end(), asset, asset + 32);
      be64(amount, b8);
      pre.insert(pre.end(), b8, b8 + 8);
    }
    uint32_t np_ = r.u16();
    for (uint32_t i = 0; i < np_; ++i) {  // preimage: raw key+value bytes
      uint32_t klen = r.u16();
      const uint8_t *k = r.take(klen);
      uint32_t vlen = r.u16();
      const uint8_t *v = r.take(vlen);
      if (r.fail) return RC_MALFORMED;
      pre.insert(pre.end(), k, k + klen);
      pre.insert(pre.end(), v, v + vlen);
    }
  } else if (kind == 3) {  // deploy contract
    tx.kind = 3;
    uint32_t clen = r.u32();
    const uint8_t *code = r.take(clen);
    if (!code) return RC_MALFORMED;
    pre.insert(pre.end(), code, code + clen);
  } else if (kind == 4) {  // multisig config payload
    tx.kind = 4;
    tx.ms_threshold = r.u8();
    uint32_t nsg = r.u8();
    if (r.fail) return RC_MALFORMED;
    // structural validation (verify.rs:404-418): invalid payloads route to
    // the Python path, which raises the canonical format error
    if (tx.ms_threshold > nsg || (nsg && !tx.ms_threshold))
      return RC_UNSUPPORTED;
    tx.ms_sg0 = (uint32_t)s->ms_signer_offs.size();
    tx.ms_n_signers = nsg;
    pre.push_back(tx.ms_threshold);
    for (uint32_t i = 0; i < nsg; ++i) {
      const uint8_t *sg = r.take(32);
      if (!sg) return RC_MALFORMED;
      if (!std::memcmp(sg, wire + tx.src_off, 32))
        return RC_UNSUPPORTED;  // source in multisig (format error)
      for (uint32_t j = 0; j < i; ++j)  // duplicate signer (format error)
        if (!std::memcmp(
                sg, wire + s->ms_signer_offs[tx.ms_sg0 + j], 32))
          return RC_UNSUPPORTED;
      s->ms_signer_offs.push_back(r.off(sg));
      s->ms_signer_rows.push_back((int32_t)s->intern.put(sg));
      pre.insert(pre.end(), sg, sg + 32);
    }
  } else {
    return RC_UNSUPPORTED;  // unknown payload kind
  }

  uint32_t n_comms = r.u8();
  tx.n_comms = n_comms;
  // wire order: commitments AFTER payload; preimage order: rangeproof THEN
  // commitments (tx/model.py to_bytes) — stash commitment bytes, append
  // after the range proof below
  size_t comm_mark = s->comms.size();
  for (uint32_t i = 0; i < n_comms; ++i) {
    CommD c{};
    const uint8_t *asset = r.take(32);
    const uint8_t *commit = r.take(32);
    const uint8_t *proof = r.take(192);
    if (r.fail) return RC_MALFORMED;
    if (!canonical32(proof + 96) || !canonical32(proof + 128) ||
        !canonical32(proof + 160))
      return RC_NONCANONICAL;
    c.asset_off = r.off(asset);
    c.commit_off = r.off(commit);
    c.proof_off = r.off(proof);
    c.commit_row = (int32_t)s->intern.put(commit);
    c.y0 = (int32_t)s->intern.put(proof);
    c.y1 = (int32_t)s->intern.put(proof + 32);
    c.y2 = (int32_t)s->intern.put(proof + 64);
    s->comms.push_back(c);
  }

  uint32_t rp_len = r.u32();
  const uint8_t *rp = r.take(rp_len);
  if (!rp) return RC_MALFORMED;
  if (rp_len < 224 + 64 || (rp_len - 224 - 64) % 64) return RC_MALFORMED;
  if (!canonical32(rp + 128) || !canonical32(rp + 160) ||
      !canonical32(rp + 192))
    return RC_NONCANONICAL;
  // final a/b scalars of the ipp
  if (!canonical32(rp + rp_len - 64) || !canonical32(rp + rp_len - 32))
    return RC_NONCANONICAL;
  tx.rp_off = r.off(rp);
  tx.lg = (rp_len - 224 - 64) / 64;
  tx.m_real = tx.n_comms + tx.n_transfers;
  if (tx.m_real == 0) return RC_RANGE_STRUCT;
  tx.m_padded = next_pow2_u32(tx.m_real);
  if ((uint64_t)64 * tx.m_padded != ((uint64_t)1 << tx.lg) ||
      tx.m_padded > s->max_party || tx.lg >= 32)
    return RC_RANGE_STRUCT;
  tx.rp_rows0 = (uint32_t)s->rp_rows.size();
  s->rp_rows.push_back((int32_t)s->intern.put(rp));        // A
  s->rp_rows.push_back((int32_t)s->intern.put(rp + 32));   // S
  s->rp_rows.push_back((int32_t)s->intern.put(rp + 64));   // T1
  s->rp_rows.push_back((int32_t)s->intern.put(rp + 96));   // T2
  for (uint32_t k = 0; k < tx.lg; ++k)  // L_k
    s->rp_rows.push_back((int32_t)s->intern.put(rp + 224 + 64 * k));
  for (uint32_t k = 0; k < tx.lg; ++k)  // R_k
    s->rp_rows.push_back((int32_t)s->intern.put(rp + 224 + 64 * k + 32));

  pre.insert(pre.end(), rp, rp + rp_len);
  for (size_t k = comm_mark; k < s->comms.size(); ++k) {
    const CommD &c = s->comms[k];
    pre.insert(pre.end(), wire + c.asset_off, wire + c.asset_off + 32);
    pre.insert(pre.end(), wire + c.commit_off, wire + c.commit_off + 32);
    pre.insert(pre.end(), wire + c.proof_off, wire + c.proof_off + 192);
  }
  // multisig offset: cosigners sign blake3 of the preimage up to HERE
  // (tx/model.py to_bytes n_bytes split; verify.rs:267)
  tx.ms_pre_len = (uint32_t)(pre.size() - tx.pre_off);

  tx.msig0 = (uint32_t)s->msig_recs.size();
  if (r.u8()) {  // carried multisig signatures
    uint32_t nm = r.u8();
    if (r.fail || nm == 0) return RC_UNSUPPORTED;  // empty list: format err
    tx.n_msigs = nm;
    for (uint32_t i = 0; i < nm; ++i) {
      uint8_t sid = r.u8();
      const uint8_t *msig = r.take(64);
      if (r.fail) return RC_MALFORMED;
      MsigRec rec{};
      rec.id = sid;
      rec.sig_off = r.off(msig);
      reduce32(msig + 32, rec.e_red);
      s->msig_recs.push_back(rec);
      // the MAIN signature's preimage includes the multisig records
      pre.push_back(sid);
      pre.insert(pre.end(), msig, msig + 64);
    }
  }
  tx.pre_len = (uint32_t)(pre.size() - tx.pre_off);

  const uint8_t *sig = r.take(64);
  if (!sig || r.p != r.end) return RC_MALFORMED;
  tx.sig_off = r.off(sig);
  reduce32(sig + 32, tx.e_red);
  tx.src_row = (int32_t)s->intern.put(wire + tx.src_off);

  tx.sigma_base = 5 * tx.n_comms + 8 * tx.n_transfers;
  tx.range_lanes = 4 + 2 * tx.lg + tx.m_padded;
  // default: one signature lane per tx; the bulk state pass rewrites the
  // bases when multisig configs add checked-cosigner lanes
  tx.sig_lane0 = (uint32_t)s->txs.size();
  lane_counts[0] = (int32_t)tx.sigma_base;
  lane_counts[1] = (int32_t)tx.range_lanes;
  lane_counts[2] = (int32_t)tx.m_padded;
  s->txs.push_back(tx);
  return RC_OK;
}

// Parse + intern every transaction of the block.  wire: concatenated tx
// wire blobs; offs: n+1 byte offsets.  lane_counts: (n, 3) int32 out.
// Returns 0 if every tx parsed, else the first nonzero rc (rcs has
// per-tx codes; the caller falls back to the Python path on any nonzero).
int xhe_blk_collect(BlockSession *s, const uint8_t *wire,
                    const uint64_t *offs, size_t n, int32_t *lane_counts,
                    int32_t *rcs) {
  s->wire = wire;
  size_t total = offs[n] - offs[0];
  s->preimage.reserve(total + 64 * n);
  int first = 0;
  for (size_t i = 0; i < n; ++i) {
    int rc = collect_one(s, wire, offs[i], offs[i + 1], lane_counts + 3 * i);
    rcs[i] = rc;
    if (rc && !first) first = rc;
    if (rc) {
      // keep indices aligned: push an empty descriptor
      if (s->txs.size() == i) s->txs.push_back(TxD{});
    }
  }
  return first;
}

size_t xhe_blk_nrows(BlockSession *s) { return s->intern.row_count(); }

// Copy the interned encodings (n_rows x 32) for device decompression.
void xhe_blk_encodings(BlockSession *s, uint8_t *out) {
  std::memcpy(out, s->intern.arena.data(), s->intern.arena.size());
}

// ---- bulk state pass -------------------------------------------------
//
// The verifier's per-tx ledger bookkeeping (verify.rs:201-485: nonce
// check/update, commitment-assets validation, homomorphic balance
// updates) runs natively for states that opt into the bulk interface
// (mock.Ledger does): the caller fetches each touched (account, asset)
// pair's INITIAL balance once, the engine replays every transaction's
// mutations sequentially, and the caller writes final balances back once
// per pair.  Equivalent to the per-tx protocol for any state whose
// get/update methods are plain map reads/writes with role-independent
// balances.

// Enumerate distinct accounts and (account, asset) pairs in protocol
// touch order (per tx: source, then commitment assets, then transfer
// destinations — the order the sequential path would first touch them).
int xhe_blk_state_schema(BlockSession *s, int32_t *n_accounts,
                         int32_t *n_pairs) {
  size_t n = s->txs.size();
  s->acct_in.reserve(n * 2 + 8);
  s->asset_in.reserve(n + 8);
  s->pair_map.reserve(s->comms.size() + s->transfers.size());
  s->tx_acct.resize(n);
  s->comm_pair.resize(s->comms.size());
  s->transfer_pair.resize(s->transfers.size());
  const uint8_t *wire = s->wire;

  auto intern_acct = [&](uint32_t woff, bool sender) -> int32_t {
    uint32_t before = s->acct_in.row_count();
    int32_t id = (int32_t)s->acct_in.put(wire + woff);
    if ((uint32_t)id == before) {  // new
      s->acct_off.push_back(woff);
      s->acct_sender.push_back(sender ? 1 : 0);
    } else if (sender) {
      s->acct_sender[id] = 1;
    }
    return id;
  };
  auto intern_asset = [&](uint32_t woff) -> int32_t {
    uint32_t before = s->asset_in.row_count();
    int32_t id = (int32_t)s->asset_in.put(wire + woff);
    if ((uint32_t)id == before) s->asset_woff.push_back(woff);
    return id;
  };
  auto touch_pair = [&](int32_t aid, int32_t asid, uint8_t role) -> int32_t {
    uint64_t key = ((uint64_t)(uint32_t)aid << 32) | (uint32_t)asid;
    int32_t next = (int32_t)s->pair_acct.size();
    int32_t got = s->pair_map.get_or_add(key, next);
    if (got < 0) {  // newly added
      s->pair_acct.push_back(aid);
      s->pair_asset.push_back(asid);
      s->pair_role.push_back(role);
      return next;
    }
    return got;
  };

  for (size_t i = 0; i < n; ++i) {
    const TxD &tx = s->txs[i];
    int32_t aid = intern_acct(tx.src_off, true);
    s->tx_acct[i] = aid;
    for (uint32_t ci = 0; ci < tx.n_comms; ++ci) {
      const CommD &c = s->comms[tx.cm0 + ci];
      s->comm_pair[tx.cm0 + ci] = touch_pair(aid, intern_asset(c.asset_off), 0);
    }
    if (tx.kind == 0) {
      for (uint32_t fi = 0; fi < tx.n_transfers; ++fi) {
        const TransferD &t = s->transfers[tx.tr0 + fi];
        int32_t did = intern_acct(t.dest_off, false);
        s->transfer_pair[tx.tr0 + fi] =
            touch_pair(did, intern_asset(t.asset_off), 1);
      }
    }
  }
  *n_accounts = (int32_t)s->acct_in.row_count();
  *n_pairs = (int32_t)s->pair_acct.size();
  s->bulk = true;
  return 0;
}

// Copy the schema tables out for the caller's state fetches.
void xhe_blk_state_tables(BlockSession *s, uint32_t *acct_off,
                          uint8_t *acct_sender, int32_t *pair_acct,
                          uint32_t *pair_asset_off, uint8_t *pair_role) {
  size_t na = s->acct_off.size(), np = s->pair_acct.size();
  std::memcpy(acct_off, s->acct_off.data(), na * 4);
  std::memcpy(acct_sender, s->acct_sender.data(), na);
  std::memcpy(pair_acct, s->pair_acct.data(), np * 4);
  for (size_t p = 0; p < np; ++p)
    pair_asset_off[p] = s->asset_woff[s->pair_asset[p]];
  std::memcpy(pair_role, s->pair_role.data(), np);
}

// Sequential state pass over every transaction: nonce check/update,
// commitment-assets validation, balance bookkeeping + per-commitment
// snapshots.  init_blob/init_offs: per-pair initial balances in the same
// {g, n_c, n_d, term records} format as the fold-group state blob (tag 1
// encodings not in the block are decompressed into unk_coords and take
// device rows extra_base + n_extras + k).  Outputs per-tx term_counts
// (state lanes the sigma MSM grows by) and draw_counts (64-byte random
// draws the fold pass will consume).  On failure returns the rc, with
// *first_bad = failing tx index and *bad_aux = expected nonce (RC_NONCE);
// mutations up to the failure point are kept (reference parity:
// verify.rs mutates state per tx as it streams).
int xhe_blk_state_run(BlockSession *s, const uint64_t *nonces,
                      const uint8_t *init_blob, const uint64_t *init_offs,
                      const uint8_t *ms_blob, const uint64_t *ms_offs,
                      int64_t extra_base, size_t n_extras,
                      uint8_t *unk_coords, size_t unk_cap,
                      int32_t *n_unk_out, int32_t *term_counts,
                      int32_t *draw_counts, int32_t *sig_counts,
                      int32_t *first_bad, uint64_t *bad_aux) {
  const uint8_t *wire = s->wire;
  size_t n = s->txs.size();
  size_t np = s->pair_acct.size();
  size_t n_unk = 0;
  *first_bad = -1;
  *bad_aux = 0;

  // 1. parse initial balances into the pair states
  s->pstates.assign(np, PairState{});
  s->snaps.assign(s->comms.size(), CommSnap{});
  s->nonces.assign(nonces, nonces + s->acct_off.size());
  s->unk_encs.clear();
  for (size_t p = 0; p < np; ++p) {
    PairState &P = s->pstates[p];
    P.last_role = s->pair_role[p];
    const uint8_t *sb = init_blob + init_offs[p];
    const uint8_t *sb_end = init_blob + init_offs[p + 1];
    if (sb + 36 > sb_end) return RC_MALFORMED;
    load(sb, P.g);
    sb += 32;
    uint16_t n_c, n_d;
    std::memcpy(&n_c, sb, 2);
    std::memcpy(&n_d, sb + 2, 2);
    sb += 4;
    P.c_rows.reserve(n_c + 8);
    P.d_rows.reserve(n_d + 8);
    for (uint32_t k = 0; k < (uint32_t)n_c + n_d; ++k) {
      if (sb + 6 > sb_end) return RC_MALFORMED;
      int8_t coeff = (int8_t)sb[0];
      uint8_t tag = sb[1];
      uint32_t val;
      std::memcpy(&val, sb + 2, 4);
      sb += 6;
      int32_t row;
      if (tag == 0) {
        row = (int32_t)val;
      } else if (tag == 1) {
        if (sb + 32 > sb_end) return RC_MALFORMED;
        uint32_t r0 = s->intern.get(sb);
        if (r0 != NO_ROW) {
          row = (int32_t)r0;
        } else if (n_unk < unk_cap) {
          if (!xhe_pt_decompress(sb, unk_coords + 128 * n_unk))
            return RC_STATE_DECOMP;
          row = (int32_t)(extra_base + (int64_t)n_extras + (int64_t)n_unk);
          s->unk_encs.insert(s->unk_encs.end(), sb, sb + 32);
          ++n_unk;
        } else {
          return RC_STATE_REF;
        }
        sb += 32;
      } else {
        return RC_MALFORMED;
      }
      if (k < n_c) {
        P.c_rows.push_back(row);
        P.c_coef.push_back(coeff);
      } else {
        P.d_rows.push_back(row);
        P.d_coef.push_back(coeff);
      }
    }
  }

  // 1b. initial multisig configs (per account: u8 present, u8 threshold,
  // u8 n, n x 32B signer encodings).  Signer rows resolve like any other
  // out-of-block state encoding.
  size_t n_acc = s->acct_off.size();
  s->mscfgs.assign(n_acc, MsCfg{});
  s->ms_changed.assign(n_acc, 0);
  if (ms_blob) {
    for (size_t a = 0; a < n_acc; ++a) {
      const uint8_t *mb = ms_blob + ms_offs[a];
      const uint8_t *mb_end = ms_blob + ms_offs[a + 1];
      if (mb == mb_end) continue;
      if (mb + 3 > mb_end) return RC_MALFORMED;
      MsCfg &c = s->mscfgs[a];
      c.present = mb[0] != 0;
      c.threshold = mb[1];
      uint32_t nsg = mb[2];
      mb += 3;
      if (mb + 32 * nsg != mb_end) return RC_MALFORMED;
      for (uint32_t k = 0; k < nsg; ++k, mb += 32) {
        int32_t row;
        uint32_t r0 = s->intern.get(mb);
        if (r0 != NO_ROW) {
          row = (int32_t)r0;
        } else if (n_unk < unk_cap) {
          if (!xhe_pt_decompress(mb, unk_coords + 128 * n_unk))
            return RC_STATE_DECOMP;
          row = (int32_t)(extra_base + (int64_t)n_extras + (int64_t)n_unk);
          s->unk_encs.insert(s->unk_encs.end(), mb, mb + 32);
          ++n_unk;
        } else {
          return RC_STATE_REF;
        }
        c.rows.push_back(row);
        c.enc.insert(c.enc.end(), mb, mb + 32);
      }
    }
  }
  s->sig_checks.clear();
  s->tx_sig0.assign(n, 0);
  s->tx_nsig.assign(n, 0);
  s->ms_hash.assign(n * 32, 0);
  uint32_t sig_cum = 0;
  *n_unk_out = (int32_t)n_unk;

  // 2. replay every transaction's mutations in order
  static const uint8_t Z32[32] = {0};
  for (size_t i = 0; i < n; ++i) {
    const TxD &tx = s->txs[i];
    int32_t aid = s->tx_acct[i];
    if (s->nonces[aid] != tx.nonce) {
      *first_bad = (int32_t)i;
      *bad_aux = s->nonces[aid];
      return RC_NONCE;
    }
    s->nonces[aid] = tx.nonce;

    // commitment-assets: native present, no duplicates, full coverage
    bool native = false, ok = true;
    for (uint32_t ci = 0; ci < tx.n_comms && ok; ++ci) {
      const uint8_t *a = wire + s->comms[tx.cm0 + ci].asset_off;
      if (!std::memcmp(a, Z32, 32)) native = true;
      for (uint32_t cj = ci + 1; cj < tx.n_comms; ++cj)
        if (!std::memcmp(a, wire + s->comms[tx.cm0 + cj].asset_off, 32)) {
          ok = false;
          break;
        }
    }
    if (ok && !native) ok = false;
    if (ok && tx.kind == 0) {
      for (uint32_t fi = 0; fi < tx.n_transfers && ok; ++fi) {
        const uint8_t *a = wire + s->transfers[tx.tr0 + fi].asset_off;
        bool covered = false;
        for (uint32_t ci = 0; ci < tx.n_comms; ++ci)
          if (!std::memcmp(a, wire + s->comms[tx.cm0 + ci].asset_off, 32)) {
            covered = true;
            break;
          }
        ok = covered;
      }
    } else if (ok && tx.kind == 1) {
      bool covered = false;
      for (uint32_t ci = 0; ci < tx.n_comms; ++ci)
        if (!std::memcmp(wire + tx.burn_off,
                         wire + s->comms[tx.cm0 + ci].asset_off, 32)) {
          covered = true;
          break;
        }
      ok = covered;
    } else if (ok && tx.kind == 2) {
      for (uint32_t k = 0; k < tx.n_call && ok; ++k) {
        const uint8_t *a = wire + s->call_assets[tx.ca0 + k].asset_off;
        bool covered = false;
        for (uint32_t ci = 0; ci < tx.n_comms; ++ci)
          if (!std::memcmp(a, wire + s->comms[tx.cm0 + ci].asset_off, 32)) {
            covered = true;
            break;
          }
        ok = covered;
      }
    }
    if (!ok) {
      *first_bad = (int32_t)i;
      return RC_COMMASSETS;
    }

    // multisig signature-set checks against the CURRENT config
    // (verify.rs:258-292; config mutations from earlier in-block payloads
    // are already applied).  Runs after the nonce update and before any
    // balance mutation — the same failure point as the Python path.
    {
      MsCfg &cfg = s->mscfgs[aid];
      uint32_t checked = 0;
      if (cfg.present) {
        if (tx.n_msigs == 0 || tx.n_msigs != cfg.threshold) {
          *first_bad = (int32_t)i;
          return RC_MSIG;
        }
        uint64_t seen[4] = {0, 0, 0, 0};
        xhe_blake3(s->preimage.data() + tx.pre_off, tx.ms_pre_len,
                   &s->ms_hash[32 * i]);
        s->tx_sig0[i] = (uint32_t)s->sig_checks.size();
        for (uint32_t k = 0; k < tx.n_msigs; ++k) {
          const MsigRec &rec = s->msig_recs[tx.msig0 + k];
          uint64_t bit = 1ull << (rec.id & 63);
          if (seen[rec.id >> 6] & bit) {
            *first_bad = (int32_t)i;
            return RC_MSIG;  // duplicate signer index
          }
          seen[rec.id >> 6] |= bit;
          if (rec.id < cfg.rows.size()) {  // out-of-range: silently skipped
            SigCheck sc{};
            sc.sig_off = rec.sig_off;
            sc.row = cfg.rows[rec.id];
            std::memcpy(sc.pk, &cfg.enc[32 * rec.id], 32);
            std::memcpy(sc.e_red, rec.e_red, 32);
            s->sig_checks.push_back(sc);
            ++checked;
          }
        }
        s->tx_nsig[i] = checked;
      } else if (tx.n_msigs != 0) {
        *first_bad = (int32_t)i;
        return RC_MSIG;  // unexpected multisig (verify.rs:289-291)
      }
      sig_counts[i] = (int32_t)(1 + checked);
      s->txs[i].sig_lane0 = sig_cum;
      sig_cum += 1 + checked;
    }

    int32_t terms = 0;
    for (uint32_t ci = 0; ci < tx.n_comms; ++ci) {
      const CommD &c = s->comms[tx.cm0 + ci];
      const uint8_t *asset = wire + c.asset_off;
      int32_t pid = s->comm_pair[tx.cm0 + ci];
      PairState &P = s->pstates[pid];
      // new = cur - output; output = fee*G (native) + burn (match) +
      // sum of same-asset transfer ciphertexts (sender handles)
      if (!std::memcmp(asset, Z32, 32)) {
        u64 fv[4] = {tx.fee, 0, 0, 0};
        sub_mod(P.g, fv, P.g);
      }
      if (tx.kind == 1 && !std::memcmp(asset, wire + tx.burn_off, 32)) {
        u64 bv[4] = {tx.burn_amount, 0, 0, 0};
        sub_mod(P.g, bv, P.g);
      }
      if (tx.kind == 2) {  // contract-call deposits (verify.py:94-97)
        for (uint32_t k = 0; k < tx.n_call; ++k) {
          const CallAsset &ca = s->call_assets[tx.ca0 + k];
          if (!std::memcmp(asset, wire + ca.asset_off, 32)) {
            u64 cv[4] = {ca.amount, 0, 0, 0};
            sub_mod(P.g, cv, P.g);
          }
        }
      }
      if (tx.kind == 0) {
        for (uint32_t fi = 0; fi < tx.n_transfers; ++fi) {
          const TransferD &t = s->transfers[tx.tr0 + fi];
          if (std::memcmp(asset, wire + t.asset_off, 32)) continue;
          P.c_rows.push_back(t.commit_row);
          P.c_coef.push_back(-1);
          P.d_rows.push_back(t.sh_row);
          P.d_coef.push_back(-1);
        }
      }
      P.last_role = 0;
      CommSnap &sn = s->snaps[tx.cm0 + ci];
      sn.pair = pid;
      sn.c_len = (uint32_t)P.c_rows.size();
      sn.d_len = (uint32_t)P.d_rows.size();
      std::memcpy(sn.g, P.g, 32);
      terms += (int32_t)(sn.c_len + sn.d_len);
    }
    if (tx.kind == 0) {
      for (uint32_t fi = 0; fi < tx.n_transfers; ++fi) {
        const TransferD &t = s->transfers[tx.tr0 + fi];
        PairState &P = s->pstates[s->transfer_pair[tx.tr0 + fi]];
        P.c_rows.push_back(t.commit_row);
        P.c_coef.push_back(1);
        P.d_rows.push_back(t.rh_row);
        P.d_coef.push_back(1);
        P.last_role = 1;
      }
    }
    // multisig payload: replace the account's config (verify.rs:420-426;
    // an empty signer set deletes it — mock.set_multisig_for_account)
    if (tx.kind == 4) {
      MsCfg &c = s->mscfgs[aid];
      c.present = tx.ms_n_signers > 0;
      c.threshold = tx.ms_threshold;
      c.rows.assign(s->ms_signer_rows.begin() + tx.ms_sg0,
                    s->ms_signer_rows.begin() + tx.ms_sg0 + tx.ms_n_signers);
      c.enc.clear();
      c.woffs.assign(s->ms_signer_offs.begin() + tx.ms_sg0,
                     s->ms_signer_offs.begin() + tx.ms_sg0 + tx.ms_n_signers);
      for (uint32_t k = 0; k < tx.ms_n_signers; ++k) {
        const uint8_t *e = wire + s->ms_signer_offs[tx.ms_sg0 + k];
        c.enc.insert(c.enc.end(), e, e + 32);
      }
      c.from_wire = true;
      s->ms_changed[aid] = 1;
    }

    term_counts[i] = terms;
    draw_counts[i] = (int32_t)(tx.n_comms + tx.n_transfers + 2);
  }
  return RC_OK;
}

// Changed-multisig-config emission for the caller's write-back: fills
// per-account changed/threshold/count and returns the total signer-offset
// slots a subsequent xhe_blk_ms_emit needs.
int xhe_blk_ms_sizes(BlockSession *s, uint8_t *changed, uint8_t *thr,
                     int32_t *nsg) {
  int total = 0;
  for (size_t a = 0; a < s->mscfgs.size(); ++a) {
    changed[a] = s->ms_changed[a];
    const MsCfg &c = s->mscfgs[a];
    thr[a] = c.threshold;
    nsg[a] = c.present ? (int32_t)c.rows.size() : 0;
    if (changed[a] && c.present) total += (int32_t)c.rows.size();
  }
  return total;
}

// Flattened wire offsets of changed configs' signers (changed accounts in
// account-id order).  Changed configs always come from in-block payloads,
// so every signer has a wire offset.
void xhe_blk_ms_emit(BlockSession *s, uint32_t *offs) {
  size_t w = 0;
  for (size_t a = 0; a < s->mscfgs.size(); ++a) {
    if (!s->ms_changed[a] || !s->mscfgs[a].present) continue;
    const MsCfg &c = s->mscfgs[a];
    for (size_t k = 0; k < c.woffs.size(); ++k) offs[w++] = c.woffs[k];
  }
}

// Final-state sizes for the caller's write-back allocation.
void xhe_blk_state_sizes(BlockSession *s, int32_t *c_lens, int32_t *d_lens) {
  for (size_t p = 0; p < s->pstates.size(); ++p) {
    c_lens[p] = (int32_t)s->pstates[p].c_rows.size();
    d_lens[p] = (int32_t)s->pstates[p].d_rows.size();
  }
}

// Emit final balances (rows/coeffs concatenated per pair: C terms then D
// terms), per-pair g coefficients + last-touch roles, final per-account
// nonces, and the out-of-block encodings (32B each, in unk-row order).
void xhe_blk_state_emit(BlockSession *s, int32_t *rows, int8_t *coeffs,
                        uint8_t *gcos, uint8_t *roles, uint64_t *nonces_out,
                        uint8_t *unk_encs_out) {
  size_t w = 0;
  for (size_t p = 0; p < s->pstates.size(); ++p) {
    const PairState &P = s->pstates[p];
    std::memcpy(rows + w, P.c_rows.data(), P.c_rows.size() * 4);
    std::memcpy(coeffs + w, P.c_coef.data(), P.c_coef.size());
    w += P.c_rows.size();
    std::memcpy(rows + w, P.d_rows.data(), P.d_rows.size() * 4);
    std::memcpy(coeffs + w, P.d_coef.data(), P.d_coef.size());
    w += P.d_rows.size();
    store(gcos + 32 * p, P.g);
    roles[p] = P.last_role;
  }
  std::memcpy(nonces_out, s->nonces.data(), s->nonces.size() * 8);
  std::memcpy(unk_encs_out, s->unk_encs.data(), s->unk_encs.size());
}

// Fold a group of transactions [tx_lo, tx_lo+n).
//
// state_blob/state_offs: per-tx homomorphic balance descriptors —
//   per commitment (wire order):
//     g_coeff   32 bytes (scalar mod L; the fee/burn G contribution of
//               the NEW source ciphertext, usually -fee)
//     n_c, n_d  u16 each
//     terms     n_c then n_d records of {i8 coeff(+-1), u8 tag, u32 val,
//               [32-byte encoding iff tag==1]}
//               tag 0: absolute device row = val (caller-resolved, e.g.
//                      extra_base + extra slot of a host point)
//               tag 1: inline 32-byte encoding, interned at collect
// rand64: 64 bytes per random draw, consumed in order
//   (per tx: one per commitment, one per transfer, then rho, c).
// extra_base: device row of the caller's extras[0] (identity).
//
// Outputs are written sequentially in tx order; the caller sizes them from
// the collect lane counts plus its own state term counts:
//   sigma_sc (sum sigma lanes, 32) u8 | sigma_rows int32
//   range_sc (sum range lanes, 32) u8 | range_rows int32
//   sig_s / sig_e_neg (n, 32) u8      | sig_rows int32 (pubkey rows)
//   g_lane/h_lane: (max_nm, 32) BP generator accumulators (+=)
//   b_acc/bb_acc/g_sc/h_sc: 32-byte scalar accumulators (+=)
// Per-tx rc codes land in rcs; returns nonzero if any tx failed.
// unk_coords/unk_base/unk_cap/n_unk_out: state term encodings NOT in the
// intern map (e.g. a ledger that stores compressed balances) are
// decompressed HERE (RFC 9496) into 128-byte extended coords; the caller
// uploads them as extra rows starting at device row ``unk_base``.
int xhe_blk_fold_group(BlockSession *s, size_t tx_lo, size_t n,
                       const uint8_t *state_blob, const uint64_t *state_offs,
                       const uint8_t *rand64, int64_t extra_base,
                       uint8_t *sigma_sc, int32_t *sigma_rows,
                       uint8_t *range_sc, int32_t *range_rows,
                       uint8_t *sig_s, uint8_t *sig_e_neg, int32_t *sig_rows,
                       uint8_t *g_lane, uint8_t *h_lane, uint8_t *b_acc,
                       uint8_t *bb_acc, uint8_t *g_sc, uint8_t *h_sc,
                       uint8_t *unk_coords, int64_t unk_base, size_t unk_cap,
                       int32_t *n_unk_out, int32_t *rcs) {
  const uint8_t *wire = s->wire;
  size_t sw = 0, rw = 0;  // sigma / range write cursors (lanes)
  const uint8_t *rnd = rand64;
  u64 gacc[4], hacc[4];
  load(g_sc, gacc);
  load(h_sc, hacc);
  u64 zero4[4] = {0, 0, 0, 0};
  std::vector<uint8_t> vbuf, lrbuf;
  size_t n_unk = 0;
  int any = 0;

  for (size_t ti = 0; ti < n; ++ti) {
    const TxD &tx = s->txs[tx_lo + ti];
    const uint8_t *sb = state_blob ? state_blob + state_offs[ti] : nullptr;
    const uint8_t *sb_end = state_blob ? state_blob + state_offs[ti + 1] : nullptr;
    int rc = RC_OK;

    Strobe st = s->tmpl;
    t_append_u64(&st, "version", 7, tx.version);
    t_append(&st, "source_pubkey", 13, wire + tx.src_off, 32);
    t_append_u64(&st, "fee", 3, tx.fee);
    t_append_u64(&st, "nonce", 5, tx.nonce);

    // 1. commitment equality proofs (verify.rs:294-341)
    for (uint32_t ci = 0; ci < tx.n_comms && !rc; ++ci) {
      const CommD &c = s->comms[tx.cm0 + ci];
      t_append(&st, "dom-sep", 7, (const uint8_t *)"new-commitment-proof",
               20);
      t_append(&st, "new_source_commitment_asset", 27, wire + c.asset_off,
               32);
      t_append(&st, "new_source_commitment", 21, wire + c.commit_off, 32);
      t_append(&st, "dom-sep", 7, (const uint8_t *)"equality-proof", 14);
      u64 bf[4];
      wide_reduce(rnd, bf);
      rnd += 64;
      uint8_t bfb[32], out9[9 * 32];
      store(bfb, bf);
      rc = xhe_eq_fold(&st, nullptr, 0, wire + c.proof_off,
                       wire + c.proof_off + 96, bfb, out9);
      if (rc) break;
      // lanes: P, Y0, Y1, C_dst, Y2 then D terms (out2), C terms (out3)
      static const int off5[5] = {0, 1, 4, 5, 6};
      const int32_t row5[5] = {tx.src_row, c.y0, c.y1, c.commit_row, c.y2};
      for (int k = 0; k < 5; ++k) {
        std::memcpy(sigma_sc + 32 * sw, out9 + 32 * off5[k], 32);
        sigma_rows[sw++] = row5[k];
      }
      u64 gco[4];
      u64 neg2[4], neg3[4], o2[4], o3[4];
      load(out9 + 64, o2);
      load(out9 + 96, o3);
      sub_mod(zero4, o2, neg2);
      sub_mod(zero4, o3, neg3);
      if (s->bulk && !state_blob) {
        // bulk mode: balance terms come from the state pass's snapshot —
        // a prefix of the pair's append-only term vectors, already
        // resolved to device rows
        const CommSnap &sn = s->snaps[tx.cm0 + ci];
        const PairState &P = s->pstates[sn.pair];
        std::memcpy(gco, sn.g, 32);
        for (uint32_t k = 0; k < sn.c_len; ++k) {
          store(sigma_sc + 32 * sw, P.c_coef[k] == 1 ? o3 : neg3);
          sigma_rows[sw++] = P.c_rows[k];
        }
        for (uint32_t k = 0; k < sn.d_len; ++k) {
          store(sigma_sc + 32 * sw, P.d_coef[k] == 1 ? o2 : neg2);
          sigma_rows[sw++] = P.d_rows[k];
        }
      } else {
      // state descriptor: g_coeff + C/D term lists
      if (sb + 32 + 4 > sb_end) {
        rc = RC_MALFORMED;
        break;
      }
      load(sb, gco);
      sb += 32;
      uint16_t n_c, n_d;
      std::memcpy(&n_c, sb, 2);
      std::memcpy(&n_d, sb + 2, 2);
      sb += 4;
      for (uint32_t k = 0; k < (uint32_t)n_c + n_d && !rc; ++k) {
        const u64 *pos = k < n_c ? o3 : o2;  // C terms use out3, D out2
        const u64 *neg = k < n_c ? neg3 : neg2;
        if (sb + 6 > sb_end) {
          rc = RC_MALFORMED;
          break;
        }
        int8_t coeff = (int8_t)sb[0];
        uint8_t tag = sb[1];
        uint32_t val;
        std::memcpy(&val, sb + 2, 4);
        sb += 6;
        int32_t row;
        if (tag == 0) {
          row = (int32_t)val;
        } else if (tag == 1) {
          if (sb + 32 > sb_end) {
            rc = RC_MALFORMED;
            break;
          }
          uint32_t r0 = s->intern.get(sb);
          if (r0 != NO_ROW) {
            row = (int32_t)r0;
          } else if (n_unk < unk_cap) {
            // out-of-block encoding (ledger-stored compressed balance):
            // decompress here, ride as a caller-uploaded extra row
            if (!xhe_pt_decompress(sb, unk_coords + 128 * n_unk)) {
              rc = RC_STATE_DECOMP;
              break;
            }
            row = (int32_t)(unk_base + (int64_t)n_unk);
            ++n_unk;
          } else {
            rc = RC_STATE_REF;
            break;
          }
          sb += 32;
        } else {
          rc = RC_MALFORMED;
          break;
        }
        store(sigma_sc + 32 * sw, coeff == 1 ? pos : neg);
        sigma_rows[sw++] = row;
      }
      if (rc) break;
      }
      // g += out7 + g_coeff*out3 ; h += out8
      u64 t1[4], t2[4];
      mul_mod(gco, o3, t1);
      load(out9 + 224, t2);
      add_mod(gacc, t2, gacc);
      add_mod(gacc, t1, gacc);
      load(out9 + 256, t1);
      add_mod(hacc, t1, hacc);
    }

    // 2. transfers / burn (verify.rs:343-430)
    if (!rc && tx.kind == 0) {
      for (uint32_t fi = 0; fi < tx.n_transfers && !rc; ++fi) {
        const TransferD &t = s->transfers[tx.tr0 + fi];
        t_append(&st, "dom-sep", 7, (const uint8_t *)"transfer-proof", 14);
        t_append(&st, "dest_pubkey", 11, wire + t.dest_off, 32);
        t_append(&st, "amount_commitment", 17, wire + t.commit_off, 32);
        t_append(&st, "amount_sender_handle", 20, wire + t.sh_off, 32);
        t_append(&st, "amount_receiver_handle", 22, wire + t.rh_off, 32);
        t_append(&st, "dom-sep", 7, (const uint8_t *)"validity-proof", 14);
        u64 bf[4];
        wide_reduce(rnd, bf);
        rnd += 64;
        uint8_t bfb[32], out10[10 * 32];
        store(bfb, bf);
        rc = xhe_validity_fold(&st, nullptr, 0, wire + t.proof_off,
                               wire + t.proof_off + 96, bfb, out10);
        if (rc) break;
        const int32_t rows8[8] = {t.commit_row, t.y0,       t.dest_row,
                                  t.rh_row,     t.y1,       tx.src_row,
                                  t.sh_row,     t.y2};
        for (int k = 0; k < 8; ++k) {
          std::memcpy(sigma_sc + 32 * sw, out10 + 32 * k, 32);
          sigma_rows[sw++] = rows8[k];
        }
        u64 t1[4];
        load(out10 + 256, t1);
        add_mod(gacc, t1, gacc);
        load(out10 + 288, t1);
        add_mod(hacc, t1, hacc);
      }
    } else if (!rc && tx.kind == 1) {
      t_append(&st, "dom-sep", 7, (const uint8_t *)"burn-proof", 10);
      t_append(&st, "asset", 5, wire + tx.burn_off, 32);
      t_append_u64(&st, "amount", 6, tx.burn_amount);
    } else if (!rc && tx.kind == 4) {
      // multisig payload appends (verify.rs:420-424); contract payloads
      // (kinds 2/3) append nothing (verify.rs:427 `_ => ()`)
      t_append(&st, "dom-sep", 7, (const uint8_t *)"multisig-proof", 14);
      t_append_u64(&st, "threshold", 9, tx.ms_threshold);
      for (uint32_t k = 0; k < tx.ms_n_signers; ++k)
        t_append(&st, "signer", 6,
                 wire + s->ms_signer_offs[tx.ms_sg0 + k], 32);
    }

    // 3. aggregated range proof (bp fold runs the rangeproof transcript)
    if (!rc) {
      u64 rho[4], cc[4];
      wide_reduce(rnd, rho);
      rnd += 64;
      wide_reduce(rnd, cc);
      rnd += 64;
      uint8_t rhob[32], ccb[32];
      store(rhob, rho);
      store(ccb, cc);
      vbuf.assign((size_t)tx.m_padded * 32, 0);
      for (uint32_t k = 0; k < tx.n_comms; ++k)
        std::memcpy(&vbuf[32 * k], wire + s->comms[tx.cm0 + k].commit_off,
                    32);
      for (uint32_t k = 0; k < tx.n_transfers; ++k)
        std::memcpy(&vbuf[32 * (tx.n_comms + k)],
                    wire + s->transfers[tx.tr0 + k].commit_off, 32);
      const uint8_t *rp = wire + tx.rp_off;
      lrbuf.resize((size_t)2 * tx.lg * 32);
      for (uint32_t k = 0; k < tx.lg; ++k) {
        std::memcpy(&lrbuf[32 * k], rp + 224 + 64 * k, 32);
        std::memcpy(&lrbuf[32 * (tx.lg + k)], rp + 224 + 64 * k + 32, 32);
      }
      size_t rp_len = 224 + 64 * tx.lg + 64;
      rc = xhe_bp_fold(&st, nullptr, 0, rp, lrbuf.data(), tx.lg, rp + 128,
                       rp + rp_len - 64, vbuf.data(), tx.m_padded, 64, rhob,
                       ccb, range_sc + 32 * rw, g_lane, h_lane, b_acc,
                       bb_acc);
      if (!rc) {
        const int32_t *rr = s->rp_rows.data() + tx.rp_rows0;
        for (uint32_t k = 0; k < 4 + 2 * tx.lg; ++k)
          range_rows[rw + k] = rr[k];
        size_t vb = rw + 4 + 2 * tx.lg;
        for (uint32_t k = 0; k < tx.n_comms; ++k)
          range_rows[vb + k] = s->comms[tx.cm0 + k].commit_row;
        for (uint32_t k = 0; k < tx.n_transfers; ++k)
          range_rows[vb + tx.n_comms + k] =
              s->transfers[tx.tr0 + k].commit_row;
        for (uint32_t k = tx.m_real; k < tx.m_padded; ++k)
          range_rows[vb + k] = 0;  // identity padding (intern row 0)
        rw += tx.range_lanes;
      }
    }

    // 4. signature lanes: s*H + (-e)*P, R checked against SHA3 at the
    // end.  Lane 0 = the tx's own signature; lanes 1.. = the CHECKED
    // multisig cosigner signatures (bulk mode; tx_nsig filled by the
    // state pass, always one lane per tx otherwise).
    size_t lb = tx.sig_lane0 - s->txs[tx_lo].sig_lane0;
    uint32_t nms = s->tx_nsig.empty() ? 0 : s->tx_nsig[tx_lo + ti];
    if (!rc) {
      u64 sred[4], eneg[4];
      reduce32(wire + tx.sig_off, sred);
      store(sig_s + 32 * lb, sred);
      sub_mod(zero4, tx.e_red, eneg);
      store(sig_e_neg + 32 * lb, eneg);
      sig_rows[lb] = tx.src_row;
      for (uint32_t k = 0; k < nms; ++k) {
        const SigCheck &sc = s->sig_checks[s->tx_sig0[tx_lo + ti] + k];
        reduce32(wire + sc.sig_off, sred);
        store(sig_s + 32 * (lb + 1 + k), sred);
        sub_mod(zero4, sc.e_red, eneg);
        store(sig_e_neg + 32 * (lb + 1 + k), eneg);
        sig_rows[lb + 1 + k] = sc.row;
      }
    } else {
      for (uint32_t k = 0; k < 1 + nms; ++k) {
        std::memset(sig_s + 32 * (lb + k), 0, 32);
        std::memset(sig_e_neg + 32 * (lb + k), 0, 32);
        sig_rows[lb + k] = (int32_t)extra_base;  // identity
      }
    }

    rcs[ti] = rc;
    if (rc) any = 1;
  }
  store(g_sc, gacc);
  store(h_sc, hacc);
  *n_unk_out = (int32_t)n_unk;
  (void)extra_base;
  return any;
}

// Final Schnorr hash checks for txs [tx_lo, tx_lo+n).  r_bytes holds one
// device-compressed R row per SIGNATURE LANE (main sig + checked multisig
// cosigners, the fold pass's lane order); ok_out is per lane.  Main lane:
// e == SHA3-512(pk || preimage || R); multisig lane: e == SHA3-512(
// pk_signer || blake3(preimage[..multisig_offset]) || R) — the cosigner
// message is the 32-byte tx hash (builder.rs:190-195, verify.rs:267).
// Returns number of failures.
int xhe_blk_sig_check(BlockSession *s, size_t tx_lo, size_t n,
                      const uint8_t *r_bytes, int32_t *ok_out) {
  int bad = 0;
  const size_t RATE = 72;
  uint32_t lane0 = s->txs[tx_lo].sig_lane0;
  for (size_t i = 0; i < n; ++i) {
    const TxD &tx = s->txs[tx_lo + i];
    size_t lb = tx.sig_lane0 - lane0;
    // streaming SHA3-512 over pk || msg || R without concatenation
    uint8_t st[200] = {0};
    size_t pos = 0;
    auto absorb = [&](const uint8_t *d, size_t len) {
      for (size_t k = 0; k < len; ++k) {
        st[pos++] ^= d[k];
        if (pos == RATE) {
          xhe_keccak_f1600(st);
          pos = 0;
        }
      }
    };
    absorb(s->wire + tx.src_off, 32);
    absorb(s->preimage.data() + tx.pre_off, tx.pre_len);
    absorb(r_bytes + 32 * lb, 32);
    st[pos] ^= 0x06;
    st[RATE - 1] ^= 0x80;
    xhe_keccak_f1600(st);
    u64 e2[4];
    wide_reduce(st, e2);
    int ok = !std::memcmp(e2, tx.e_red, 32);
    ok_out[lb] = ok;
    if (!ok) ++bad;
    uint32_t nms = s->tx_nsig.empty() ? 0 : s->tx_nsig[tx_lo + i];
    for (uint32_t k = 0; k < nms; ++k) {
      const SigCheck &sc = s->sig_checks[s->tx_sig0[tx_lo + i] + k];
      std::memset(st, 0, sizeof(st));
      pos = 0;
      absorb(sc.pk, 32);
      absorb(&s->ms_hash[32 * (tx_lo + i)], 32);
      absorb(r_bytes + 32 * (lb + 1 + k), 32);
      st[pos] ^= 0x06;
      st[RATE - 1] ^= 0x80;
      xhe_keccak_f1600(st);
      wide_reduce(st, e2);
      ok = !std::memcmp(e2, sc.e_red, 32);
      ok_out[lb + 1 + k] = ok;
      if (!ok) ++bad;
    }
  }
  return bad;
}

}  // extern "C"
