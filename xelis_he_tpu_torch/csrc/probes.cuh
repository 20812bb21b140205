// Per-thread bodies of the roofline probes K11-K14 (csrc/probe_*.cu).
//
// The JAX package measures its TPU with three scripts (scripts/
// bench_roofline.py, bench_fe13.py, bench_qtile.py) whose Pallas kernels
// loop one operation over four independent chains and write the XOR of the
// chains.  These are the same loops, one lane a thread:
//
//   K11 probe_imad       x = x * y + 1, 81 steps a rep on 4 chains (the raw
//                        u32 multiply-add of bench_roofline.py's make_raw);
//                        a second form runs the chain as a 32x32 -> 64-bit
//                        multiply-add, acc = lo(acc) * y + acc, the form of
//                        the CUDA field's column sums; a third as the high
//                        word's multiply-add, x = hi32(x * y) + x
//                        (mad.hi.u32)
//   K12 probe_mul15      the JAX kernels' 18 x 15-bit _mul_t (pallas_msm.py
//                        _mul_t, _carry_t), limb for limb, as column sums
//   K13 probe_mul13      the 20 x 13-bit _mul13 (3-pass carry), the 2-pass
//                        form of bench_fe13.py, and that form with the
//                        consumer's _carry13, limb for limb
//   K14 probe_fe         the port's own fe_mul / fe_sq (ed25519.cuh) on the
//                        radix-2^25.5 tier and on fe15, chained on 4 chains
//
// K11-K13 compute in uint32 and wrap as the TPU's u32 lanes do (the JAX
// helpers' inputs keep every sum below 2^32, so nothing wraps there).
// Like ed25519.cuh, every function is XHE_HD, and the host build
// (g++ -x c++ -DXHE_HD= -DXHE_NOINLINE=) runs the same code in the CPU tests.

#pragma once
#include "ed25519.cuh"

namespace xhe {

constexpr int PROBE_CHAINS = 4;   // independent chains a lane
constexpr int PROBE_STEPS = 81;   // K11's multiply-adds a chain a rep
constexpr int P15_LIMBS = 18;     // _mul_t's 15-bit limbs
constexpr int P13_LIMBS = 20;     // _mul13's 13-bit limbs
constexpr uint32_t P15_MASK = 0x7fffu;
constexpr uint32_t P13_MASK = 0x1fffu;
constexpr uint32_t P13_FOLD = 608u;  // 2^(13 * 20 - 255) * 19

// K13's modes, in bench_fe13.py's order
enum { MUL13_3PASS = 0, MUL13_2PASS_CONSUMER = 1, MUL13_2PASS = 2 };

// -- K11 --------------------------------------------------------------------------

static XHE_HD uint32_t probe_imad(uint32_t x, uint32_t y, int reps) {
  uint32_t c[PROBE_CHAINS];
#pragma unroll
  for (int k = 0; k < PROBE_CHAINS; ++k) c[k] = x + (uint32_t)k;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int s = 0; s < PROBE_STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < PROBE_CHAINS; ++k) c[k] = c[k] * y + 1u;
    }
  }
  return c[0] ^ c[1] ^ c[2] ^ c[3];
}

// each step one 32 x 32 -> 64-bit product added to a 64-bit sum, the next
// step's factor the sum's low word; out is the XOR of the sums' two words
static XHE_HD uint32_t probe_imad_wide(uint32_t x, uint32_t y, int reps) {
  uint64_t a[PROBE_CHAINS];
#pragma unroll
  for (int k = 0; k < PROBE_CHAINS; ++k) a[k] = (uint32_t)(x + (uint32_t)k);
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int s = 0; s < PROBE_STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < PROBE_CHAINS; ++k) a[k] = (uint64_t)(uint32_t)a[k] * y + a[k];
    }
  }
  uint32_t out = 0;
#pragma unroll
  for (int k = 0; k < PROBE_CHAINS; ++k) out ^= (uint32_t)a[k] ^ (uint32_t)(a[k] >> 32);
  return out;
}

// hi32(a * b) + c: one mad.hi.u32 (IMAD.HI.U32 on the card)
static XHE_HD uint32_t mad_hi(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("mad.hi.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return (uint32_t)(((uint64_t)a * b) >> 32) + c;
#endif
}

// each step x = hi32(x * y) + x, one mad.hi.u32: its rate against the u32
// form's says what a product's high part costs in issue slots
static XHE_HD uint32_t probe_imad_hi(uint32_t x, uint32_t y, int reps) {
  uint32_t c[PROBE_CHAINS];
#pragma unroll
  for (int k = 0; k < PROBE_CHAINS; ++k) c[k] = x + (uint32_t)k;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int s = 0; s < PROBE_STEPS; ++s) {
#pragma unroll
      for (int k = 0; k < PROBE_CHAINS; ++k) c[k] = mad_hi(c[k], y, c[k]);
    }
  }
  return c[0] ^ c[1] ^ c[2] ^ c[3];
}

// -- K12: _mul_t ------------------------------------------------------------------

// _carry_t: each limb keeps its low 15 bits and takes its lower neighbour's
// high bits; limb 17's high bits wrap into limb 1 times 19
static XHE_HD void carry_t(uint32_t t[P15_LIMBS]) {
  uint32_t hi[P15_LIMBS];
#pragma unroll
  for (int i = 0; i < P15_LIMBS; ++i) {
    hi[i] = t[i] >> 15;
    t[i] &= P15_MASK;
  }
#pragma unroll
  for (int i = 1; i < P15_LIMBS; ++i) t[i] += hi[i - 1];
  t[1] += hi[P15_LIMBS - 1] * 19u;
}

// h = a * b as _mul_t: its 36 columns bit for bit, then its fold (columns
// 18-34 into 1-17 times 19, column 35 into 1 times 361) and two carries.  h
// may alias a.
//
// The JAX kernels split every product p = a_i b_j at bit 15 and add p &
// 0x7fff to its column and p >> 15 to the next: on the card a mask, a shift
// and an add (ALU pipe) beside each multiply.  Here column c sums its
// products whole, S_c = sum a_i b_j mod 2^32, and their high parts apart,
// H_c = sum p >> 15 (LEA.HI adds one in one instruction); then col_c = S_c -
// (H_c << 15) + H_(c-1), which holds mod 2^32 and so exactly (every column is
// below 2^22).  Needs every limb of a and b below 2^16 (_mul_t's relaxed
// limbs are at most 2^15 + 2^11): then no product wraps.
static XHE_HD void mul_t(uint32_t h[P15_LIMBS], const uint32_t a[P15_LIMBS], const uint32_t b[P15_LIMBS]) {
  uint32_t acc[2 * P15_LIMBS];
  uint32_t hprev = 0;
#pragma unroll
  for (int c = 0; c < 2 * P15_LIMBS - 1; ++c) {
    uint32_t s = 0, hs = 0;
#pragma unroll
    for (int i = 0; i < P15_LIMBS; ++i) {
      const int j = c - i;
      if (j < 0 || j >= P15_LIMBS) continue;
      const uint32_t p = a[i] * b[j];
      s += p;
      hs += p >> 15;
    }
    acc[c] = s - (hs << 15) + hprev;
    hprev = hs;
  }
  acc[2 * P15_LIMBS - 1] = hprev;
#pragma unroll
  for (int k = 1; k < P15_LIMBS; ++k) acc[k] += acc[k + P15_LIMBS - 1] * 19u;
  acc[1] += acc[2 * P15_LIMBS - 1] * 361u;
  carry_t(acc);
  carry_t(acc);
#pragma unroll
  for (int k = 0; k < P15_LIMBS; ++k) h[k] = acc[k];
}

// -- K13: _mul13 and bench_fe13.py's variants ---------------------------------

// _carry13: for small slack; limb 19's carry wraps into limb 0 times 608
static XHE_HD void carry13(uint32_t t[P13_LIMBS]) {
  uint32_t cy[P13_LIMBS];
#pragma unroll
  for (int i = 0; i < P13_LIMBS; ++i) {
    cy[i] = t[i] >> 13;
    t[i] &= P13_MASK;
  }
#pragma unroll
  for (int i = 1; i < P13_LIMBS; ++i) t[i] += cy[i - 1];
  t[0] += cy[P13_LIMBS - 1] * P13_FOLD;
}

// _carry13_wide: limb 19's carry split at bit 13 before its x608 wrap
static XHE_HD void carry13_wide(uint32_t t[P13_LIMBS]) {
  uint32_t cy[P13_LIMBS];
#pragma unroll
  for (int i = 0; i < P13_LIMBS; ++i) {
    cy[i] = t[i] >> 13;
    t[i] &= P13_MASK;
  }
#pragma unroll
  for (int i = 1; i < P13_LIMBS; ++i) t[i] += cy[i - 1];
  const uint32_t top = cy[P13_LIMBS - 1];
  t[0] += (top & P13_MASK) * P13_FOLD;
  t[1] += (top >> 13) * P13_FOLD;
}

// h = a * b in MODE: the 39 column sums, columns 20-38 folded split at bit 13
// (times 608 into columns 0-18 and 1-19), a wide and a simple carry (the
// 2-pass form); MUL13_3PASS adds _carry13_mul_out's row-0 fixup,
// MUL13_2PASS_CONSUMER the consumer's _carry13.  h may alias a.
template <int MODE>
static XHE_HD void mul13(uint32_t h[P13_LIMBS], const uint32_t a[P13_LIMBS], const uint32_t b[P13_LIMBS]) {
  uint32_t acc[2 * P13_LIMBS - 1];
#pragma unroll
  for (int k = 0; k < 2 * P13_LIMBS - 1; ++k) acc[k] = 0;
#pragma unroll
  for (int j = 0; j < P13_LIMBS; ++j) {
#pragma unroll
    for (int i = 0; i < P13_LIMBS; ++i) acc[i + j] += a[i] * b[j];
  }
  uint32_t low[P13_LIMBS];
#pragma unroll
  for (int k = 0; k < P13_LIMBS; ++k) low[k] = acc[k];
#pragma unroll
  for (int k = 0; k < P13_LIMBS - 1; ++k) {
    const uint32_t hi = acc[P13_LIMBS + k];
    low[k] += (hi & P13_MASK) * P13_FOLD;
    low[k + 1] += (hi >> 13) * P13_FOLD;
  }
  carry13_wide(low);
  carry13(low);
  if (MODE == MUL13_3PASS) {
    low[1] += low[0] >> 13;
    low[0] &= P13_MASK;
  } else if (MODE == MUL13_2PASS_CONSUMER) {
    carry13(low);
  }
#pragma unroll
  for (int k = 0; k < P13_LIMBS; ++k) h[k] = low[k];
}

// -- the lane bodies ----------------------------------------------------------------
//
// A lane's limbs are column t of a (rows, T) array: limb r at r * T + t.
// Chain k starts from the lane's x with k added to every limb, as the JAX
// kernels' x_ref[:] + k.

static XHE_HD void probe_mul15(uint32_t *out, const uint32_t *x, const uint32_t *y, int T, int t, int reps) {
  uint32_t b[P15_LIMBS], c[PROBE_CHAINS][P15_LIMBS];
#pragma unroll
  for (int i = 0; i < P15_LIMBS; ++i) {
    b[i] = y[(size_t)i * T + t];
    const uint32_t v = x[(size_t)i * T + t];
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) c[k][i] = v + (uint32_t)k;
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) mul_t(c[k], c[k], b);
  }
#pragma unroll
  for (int i = 0; i < P15_LIMBS; ++i) out[(size_t)i * T + t] = c[0][i] ^ c[1][i] ^ c[2][i] ^ c[3][i];
}

template <int MODE>
static XHE_HD void probe_mul13(uint32_t *out, const uint32_t *x, const uint32_t *y, int T, int t, int reps) {
  uint32_t b[P13_LIMBS], c[PROBE_CHAINS][P13_LIMBS];
#pragma unroll
  for (int i = 0; i < P13_LIMBS; ++i) {
    b[i] = y[(size_t)i * T + t];
    const uint32_t v = x[(size_t)i * T + t];
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) c[k][i] = v + (uint32_t)k;
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) mul13<MODE>(c[k], c[k], b);
  }
#pragma unroll
  for (int i = 0; i < P13_LIMBS; ++i) out[(size_t)i * T + t] = c[0][i] ^ c[1][i] ^ c[2][i] ^ c[3][i];
}

// K14: F is fe (10 limbs) or fe15 (18); SQ picks fe_sq(c) over fe_mul(c, y).
// Every chain is written out (out is (4, limbs, T)) so that its value can be
// held to x_k y^reps, or x_k^(2^reps), mod p.
template <class F, bool SQ>
static XHE_HD void probe_fe(uint32_t *out, const uint32_t *x, const uint32_t *y, int T, int t, int reps) {
  constexpr int NL = sizeof(F) / sizeof(uint32_t);
  F b, c[PROBE_CHAINS];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    b.v[i] = y[(size_t)i * T + t];
    const uint32_t v = x[(size_t)i * T + t];
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) c[k].v[i] = v + (uint32_t)k;
  }
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < PROBE_CHAINS; ++k) {
      if (SQ)
        fe_sq(c[k], c[k]);
      else
        fe_mul(c[k], c[k], b);
    }
  }
#pragma unroll
  for (int k = 0; k < PROBE_CHAINS; ++k) {
#pragma unroll
    for (int i = 0; i < NL; ++i) out[((size_t)k * NL + i) * T + t] = c[k].v[i];
  }
}

}  // namespace xhe
