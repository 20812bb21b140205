// Native host kernels for the serial byte machinery (SURVEY.md D8-D11):
// Keccak-f[1600], STROBE-128 (merlin-compatible), BLAKE3, ChaCha20.
//
// These mirror the pure-Python implementations in xelis_he_tpu_torch/hashcore/
// (the ground truth for tests) and exist for host-side speed: transaction
// verification replays one merlin transcript per tx, and a 10k-tx block
// performs ~10^6 sponge permutations.
//
// Built by hashcore/native.py via: g++ -O3 -shared -fPIC hashcore.cpp
// Exposed through ctypes; no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

// ---------------------------------------------------------------------------
// Keccak-f[1600]
// ---------------------------------------------------------------------------

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}

#include "keccak_unrolled.inc"

void xhe_keccak_f1600(uint8_t *state_bytes) {
  // fully-unrolled permutation (322 vs 691 ns on the round-5 host);
  // keccak_f1600_reference below is the readable loop form it was
  // validated against (2000 random states + the FIPS-202 suite)
  uint64_t st[25];
  std::memcpy(st, state_bytes, 200);
  keccak_f1600_unrolled(st);
  std::memcpy(state_bytes, st, 200);
}

static void keccak_f1600_reference(uint8_t *state_bytes)
    __attribute__((unused));
static void keccak_f1600_reference(uint8_t *state_bytes) {
  uint64_t st[25];
  std::memcpy(st, state_bytes, 200);
  for (int round = 0; round < 24; ++round) {
    // theta
    uint64_t bc[5];
    for (int i = 0; i < 5; ++i)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; ++i) {
      uint64_t t = bc[(i + 4) % 5] ^ rotl64(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    // rho + pi
    uint64_t t = st[1];
    static const int piln[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                                 8,  21, 24, 4,  15, 23, 19, 13,
                                 12, 2,  20, 14, 22, 9,  6,  1};
    static const int rotc[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                 45, 55, 2,  14, 27, 41, 56, 8,
                                 25, 43, 62, 18, 39, 61, 20, 44};
    for (int i = 0; i < 24; ++i) {
      int j = piln[i];
      uint64_t tmp = st[j];
      st[j] = rotl64(t, rotc[i]);
      t = tmp;
    }
    // chi
    for (int j = 0; j < 25; j += 5) {
      uint64_t b[5];
      for (int i = 0; i < 5; ++i) b[i] = st[j + i];
      for (int i = 0; i < 5; ++i)
        st[j + i] = b[i] ^ ((~b[(i + 1) % 5]) & b[(i + 2) % 5]);
    }
    // iota
    st[0] ^= RC[round];
  }
  std::memcpy(state_bytes, st, 200);
}

// ---------------------------------------------------------------------------
// STROBE-128 (merlin's subset: meta_ad / ad / prf / key)
// ---------------------------------------------------------------------------

static const int STROBE_R = 166;
enum { FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_T = 8, FLAG_M = 16, FLAG_K = 32 };

struct Strobe {
  uint8_t state[200];
  uint8_t pos;
  uint8_t pos_begin;
  uint8_t cur_flags;
};

static void strobe_run_f(Strobe *s) {
  s->state[s->pos] ^= s->pos_begin;
  s->state[s->pos + 1] ^= 0x04;
  s->state[STROBE_R + 1] ^= 0x80;
  xhe_keccak_f1600(s->state);
  s->pos = 0;
  s->pos_begin = 0;
}

static void strobe_absorb(Strobe *s, const uint8_t *data, size_t len) {
  for (size_t i = 0; i < len; ++i) {
    s->state[s->pos] ^= data[i];
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_overwrite(Strobe *s, const uint8_t *data, size_t len) {
  for (size_t i = 0; i < len; ++i) {
    s->state[s->pos] = data[i];
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_squeeze(Strobe *s, uint8_t *out, size_t len) {
  for (size_t i = 0; i < len; ++i) {
    out[i] = s->state[s->pos];
    s->state[s->pos] = 0;
    if (++s->pos == STROBE_R) strobe_run_f(s);
  }
}

static void strobe_begin_op(Strobe *s, uint8_t flags, int more) {
  if (more) return;  // caller guarantees same flags (mirrors merlin asserts)
  uint8_t old_begin = s->pos_begin;
  s->pos_begin = s->pos + 1;
  s->cur_flags = flags;
  uint8_t hdr[2] = {old_begin, flags};
  strobe_absorb(s, hdr, 2);
  if ((flags & (FLAG_C | FLAG_K)) && s->pos != 0) strobe_run_f(s);
}

Strobe *xhe_strobe_new(const uint8_t *protocol_label, size_t len) {
  Strobe *s = (Strobe *)std::calloc(1, sizeof(Strobe));
  static const uint8_t init[18] = {1, STROBE_R + 2, 1,   0,   1,   96,
                                   'S', 'T', 'R', 'O', 'B', 'E',
                                   'v', '1', '.', '0', '.', '2'};
  std::memcpy(s->state, init, 18);
  xhe_keccak_f1600(s->state);
  strobe_begin_op(s, FLAG_M | FLAG_A, 0);
  strobe_absorb(s, protocol_label, len);
  return s;
}

Strobe *xhe_strobe_copy(const Strobe *src) {
  Strobe *s = (Strobe *)std::malloc(sizeof(Strobe));
  std::memcpy(s, src, sizeof(Strobe));
  return s;
}

void xhe_strobe_free(Strobe *s) { std::free(s); }

void xhe_strobe_meta_ad(Strobe *s, const uint8_t *data, size_t len, int more) {
  strobe_begin_op(s, FLAG_M | FLAG_A, more);
  strobe_absorb(s, data, len);
}

void xhe_strobe_ad(Strobe *s, const uint8_t *data, size_t len, int more) {
  strobe_begin_op(s, FLAG_A, more);
  strobe_absorb(s, data, len);
}

void xhe_strobe_prf(Strobe *s, uint8_t *out, size_t len, int more) {
  strobe_begin_op(s, FLAG_I | FLAG_A | FLAG_C, more);
  strobe_squeeze(s, out, len);
}

void xhe_strobe_key(Strobe *s, const uint8_t *data, size_t len, int more) {
  strobe_begin_op(s, FLAG_A | FLAG_C, more);
  strobe_overwrite(s, data, len);
}

// Batched transcript ops: blob is a sequence of records
//   u8 opcode (0=meta_ad, 1=ad, 2=prf, 3=key), u8 more, u32le len,
//   then `len` data bytes (absent for prf; its `len` output bytes are
//   appended to `out`).  Returns total prf bytes written.  One call per
//   Fiat-Shamir challenge replaces 10+ ctypes round trips on the
//   verification hot path.
size_t xhe_strobe_batch(Strobe *s, const uint8_t *blob, size_t blob_len,
                        uint8_t *out) {
  size_t i = 0, written = 0;
  while (i + 6 <= blob_len) {
    uint8_t op = blob[i];
    int more = blob[i + 1];
    uint32_t len = (uint32_t)blob[i + 2] | ((uint32_t)blob[i + 3] << 8) |
                   ((uint32_t)blob[i + 4] << 16) | ((uint32_t)blob[i + 5] << 24);
    i += 6;
    switch (op) {
      case 0:
        xhe_strobe_meta_ad(s, blob + i, len, more);
        i += len;
        break;
      case 1:
        xhe_strobe_ad(s, blob + i, len, more);
        i += len;
        break;
      case 2:
        xhe_strobe_prf(s, out + written, len, more);
        written += len;
        break;
      case 3:
        xhe_strobe_key(s, blob + i, len, more);
        i += len;
        break;
      default:
        return written;
    }
  }
  return written;
}

// ---------------------------------------------------------------------------
// BLAKE3 (unkeyed hash, 32-byte output, full chunk tree)
// ---------------------------------------------------------------------------

static const uint32_t B3_IV[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372,
                                  0xA54FF53A, 0x510E527F, 0x9B05688C,
                                  0x1F83D9AB, 0x5BE0CD19};
static const int B3_PERM[16] = {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8};
enum { CHUNK_START = 1, CHUNK_END = 2, PARENT = 4, ROOT = 8 };

static inline uint32_t rotr32(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

static inline void b3_g(uint32_t *st, int a, int b, int c, int d, uint32_t mx, uint32_t my) {
  st[a] = st[a] + st[b] + mx;
  st[d] = rotr32(st[d] ^ st[a], 16);
  st[c] = st[c] + st[d];
  st[b] = rotr32(st[b] ^ st[c], 12);
  st[a] = st[a] + st[b] + my;
  st[d] = rotr32(st[d] ^ st[a], 8);
  st[c] = st[c] + st[d];
  st[b] = rotr32(st[b] ^ st[c], 7);
}

static void b3_compress(const uint32_t cv[8], const uint32_t block[16],
                        uint64_t counter, uint32_t block_len, uint32_t flags,
                        uint32_t out[16]) {
  uint32_t st[16];
  uint32_t m[16];
  std::memcpy(st, cv, 32);
  std::memcpy(st + 8, B3_IV, 16);
  st[12] = (uint32_t)counter;
  st[13] = (uint32_t)(counter >> 32);
  st[14] = block_len;
  st[15] = flags;
  std::memcpy(m, block, 64);
  for (int r = 0;; ++r) {
    b3_g(st, 0, 4, 8, 12, m[0], m[1]);
    b3_g(st, 1, 5, 9, 13, m[2], m[3]);
    b3_g(st, 2, 6, 10, 14, m[4], m[5]);
    b3_g(st, 3, 7, 11, 15, m[6], m[7]);
    b3_g(st, 0, 5, 10, 15, m[8], m[9]);
    b3_g(st, 1, 6, 11, 12, m[10], m[11]);
    b3_g(st, 2, 7, 8, 13, m[12], m[13]);
    b3_g(st, 3, 4, 9, 14, m[14], m[15]);
    if (r == 6) break;
    uint32_t perm[16];
    for (int i = 0; i < 16; ++i) perm[i] = m[B3_PERM[i]];
    std::memcpy(m, perm, 64);
  }
  for (int i = 0; i < 8; ++i) {
    out[i] = st[i] ^ st[i + 8];
    out[i + 8] = st[i + 8] ^ cv[i];
  }
}

static void b3_load_block(const uint8_t *p, size_t len, uint32_t out[16]) {
  uint8_t buf[64];
  std::memset(buf, 0, 64);
  std::memcpy(buf, p, len);
  for (int i = 0; i < 16; ++i)
    out[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
             ((uint32_t)buf[4 * i + 2] << 16) | ((uint32_t)buf[4 * i + 3] << 24);
}

// chunk CV for a full (or final partial) chunk
static void b3_chunk_cv(const uint8_t *chunk, size_t len, uint64_t counter,
                        uint32_t cv_out[8]) {
  uint32_t cv[8];
  std::memcpy(cv, B3_IV, 32);
  size_t nblocks = len == 0 ? 1 : (len + 63) / 64;
  for (size_t b = 0; b < nblocks; ++b) {
    size_t off = b * 64;
    size_t blen = (b == nblocks - 1) ? len - off : 64;
    uint32_t flags = 0;
    if (b == 0) flags |= CHUNK_START;
    if (b == nblocks - 1) flags |= CHUNK_END;
    uint32_t block[16], out[16];
    b3_load_block(chunk + off, blen, block);
    b3_compress(cv, block, counter, (uint32_t)blen, flags, out);
    std::memcpy(cv, out, 32);
  }
  std::memcpy(cv_out, cv, 32);
}

// recursive tree merge; returns CV (non-root) in cv_out
static void b3_merge(const uint32_t *cvs, size_t n, int is_root, uint32_t cv_out[16]) {
  if (n == 1) {
    std::memcpy(cv_out, cvs, 32);
    return;
  }
  size_t split = 1;
  while (split * 2 < n) split *= 2;
  uint32_t left[16], right[16];
  b3_merge(cvs, split, 0, left);
  b3_merge(cvs + 8 * split, n - split, 0, right);
  uint32_t block[16];
  std::memcpy(block, left, 32);
  std::memcpy(block + 8, right, 32);
  b3_compress(B3_IV, block, 0, 64, is_root ? (PARENT | ROOT) : PARENT, cv_out);
}

void xhe_blake3(const uint8_t *data, size_t len, uint8_t out[32]) {
  if (len <= 1024) {
    // single chunk: root flags on the last block
    uint32_t cv[8];
    std::memcpy(cv, B3_IV, 32);
    size_t nblocks = len == 0 ? 1 : (len + 63) / 64;
    uint32_t res[16];
    for (size_t b = 0; b < nblocks; ++b) {
      size_t off = b * 64;
      size_t blen = (b == nblocks - 1) ? len - off : 64;
      uint32_t flags = 0;
      if (b == 0) flags |= CHUNK_START;
      if (b == nblocks - 1) flags |= CHUNK_END | ROOT;
      uint32_t block[16];
      b3_load_block(data + off, blen, block);
      b3_compress(cv, block, 0, (uint32_t)blen, flags, res);
      if (b != nblocks - 1) std::memcpy(cv, res, 32);
    }
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = (uint8_t)res[i];
      out[4 * i + 1] = (uint8_t)(res[i] >> 8);
      out[4 * i + 2] = (uint8_t)(res[i] >> 16);
      out[4 * i + 3] = (uint8_t)(res[i] >> 24);
    }
    return;
  }
  size_t nchunks = (len + 1023) / 1024;
  uint32_t *cvs = (uint32_t *)std::malloc(nchunks * 32);
  for (size_t c = 0; c < nchunks; ++c) {
    size_t off = c * 1024;
    size_t clen = (c == nchunks - 1) ? len - off : 1024;
    b3_chunk_cv(data + off, clen, c, cvs + 8 * c);
  }
  uint32_t res[16];
  b3_merge(cvs, nchunks, 1, res);
  std::free(cvs);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)res[i];
    out[4 * i + 1] = (uint8_t)(res[i] >> 8);
    out[4 * i + 2] = (uint8_t)(res[i] >> 16);
    out[4 * i + 3] = (uint8_t)(res[i] >> 24);
  }
}

// ---------------------------------------------------------------------------
// ChaCha20 (RFC 8439 quarter rounds, 12-byte nonce, 32-bit counter)
// ---------------------------------------------------------------------------

static inline uint32_t load32(const uint8_t *p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

#define QR(a, b, c, d)                \
  a += b; d ^= a; d = rotr32(d, 16);  \
  c += d; b ^= c; b = rotr32(b, 20);  \
  a += b; d ^= a; d = rotr32(d, 24);  \
  c += d; b ^= c; b = rotr32(b, 25);

void xhe_chacha20_xor(const uint8_t key[32], const uint8_t nonce[12],
                      uint32_t counter, uint8_t *data, size_t len) {
  uint32_t init[16] = {0x61707865, 0x3320646E, 0x79622D32, 0x6B206574};
  for (int i = 0; i < 8; ++i) init[4 + i] = load32(key + 4 * i);
  init[12] = counter;
  for (int i = 0; i < 3; ++i) init[13 + i] = load32(nonce + 4 * i);
  for (size_t off = 0; off < len; off += 64, ++init[12]) {
    uint32_t x[16];
    std::memcpy(x, init, 64);
    for (int r = 0; r < 10; ++r) {
      QR(x[0], x[4], x[8], x[12]);
      QR(x[1], x[5], x[9], x[13]);
      QR(x[2], x[6], x[10], x[14]);
      QR(x[3], x[7], x[11], x[15]);
      QR(x[0], x[5], x[10], x[15]);
      QR(x[1], x[6], x[11], x[12]);
      QR(x[2], x[7], x[8], x[13]);
      QR(x[3], x[4], x[9], x[14]);
    }
    uint8_t ks[64];
    for (int i = 0; i < 16; ++i) {
      uint32_t v = x[i] + init[i];
      ks[4 * i] = (uint8_t)v;
      ks[4 * i + 1] = (uint8_t)(v >> 8);
      ks[4 * i + 2] = (uint8_t)(v >> 16);
      ks[4 * i + 3] = (uint8_t)(v >> 24);
    }
    size_t n = len - off < 64 ? len - off : 64;
    for (size_t i = 0; i < n; ++i) data[off + i] ^= ks[i];
  }
}

// SHA3-512 (FIPS 202) — used for signature hashing when batching many txs
void xhe_sha3_512(const uint8_t *data, size_t len, uint8_t out[64]) {
  const size_t rate = 72;
  uint8_t st[200];
  std::memset(st, 0, 200);
  size_t i = 0;
  size_t pos = 0;
  for (; i < len; ++i) {
    st[pos] ^= data[i];
    if (++pos == rate) {
      xhe_keccak_f1600(st);
      pos = 0;
    }
  }
  st[pos] ^= 0x06;
  st[rate - 1] ^= 0x80;
  xhe_keccak_f1600(st);
  std::memcpy(out, st, 64);
}

}  // extern "C"
