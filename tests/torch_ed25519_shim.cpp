// Host build of xelis_he_tpu_torch/csrc/ed25519.cuh for the CPU tests:
// the kernels' per-thread bodies run here on plain loops, one item at a
// time, so their arithmetic is checked without a GPU.
//   g++ -x c++ -DXHE_HD= -DXHE_NOINLINE= -DXHE_COUNT_MULS -O2 -shared -fPIC -I<csrc> this.cpp

#include <vector>

#include "ed25519.cuh"

using namespace xhe;

// K2 and K6 as windowed_lanes.cu and windowed_lanes_fe15.cu run them,
// tables in a scratch of the kernels' layout: the T threads of a slot one
// after the other, then thread 0's combine
template <class F, int T>
static void packed_slots(const int32_t *pts, const uint8_t *digits, int32_t *out, int S) {
  std::vector<ge_niels_t<F>> tables((size_t)8 * K2_TABLE * S);
  for (int s = 0; s < S; ++s) {
    ge_t<F> parts[T];
    for (int j = 0; j < T; ++j)
      windowed_part_k8<F, T>(parts[j], tables.data() + (size_t)j * (8 / T) * K2_TABLE * S + s, S, pts, digits,
                             S, s, j);
    combine_parts<F, T>(parts);
    ge_to_rows(out + 72 * s, parts[0]);
  }
}

extern "C" {

// K1's body on n encodings of 32 bytes, handed over as decompress.cu reads
// them: eight little-endian words each
void shim_decompress(const uint8_t *enc, int32_t *rows, uint8_t *valid, int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t w[8];
    for (int k = 0; k < 8; ++k) {
      const uint8_t *b = enc + 32 * i + 4 * k;
      w[k] = b[0] | (uint32_t)b[1] << 8 | (uint32_t)b[2] << 16 | (uint32_t)b[3] << 24;
    }
    valid[i] = decompress_one(rows + 72 * i, w) ? 1 : 0;
  }
}

void shim_compress(const int32_t *rows, uint8_t *out, int n) {
  for (int i = 0; i < n; ++i) compress_one(out + 32 * i, rows + 72 * i);
}

// K8 as add_compress.cu runs it: lane i of the R x n grid is a[i / n] +
// b[i % n]; sums go out for the columns j >= sums_from (none when sums is
// null)
void shim_add_compress(const int32_t *a, const int32_t *b, uint8_t *enc, int32_t *sums, int R, int n,
                       int sums_from) {
  for (long long i = 0; i < (long long)R * n; ++i) {
    const k8_lane l = add_compress_lane(i, a, b, sums, n, sums_from);
    add_compress_one(enc + 32 * i, l.sum, l.a, l.b);
  }
}

// fe_reduce64 on n rows of ten 64-bit column sums -> n limb vectors
void shim_reduce64(const uint64_t *t, uint32_t *out, int n) {
  for (int i = 0; i < n; ++i) {
    uint64_t cols[10];
    for (int k = 0; k < 10; ++k) cols[k] = t[10 * i + k];
    fe h;
    fe_reduce64(h, cols);
    for (int k = 0; k < 10; ++k) out[10 * i + k] = h.v[k];
  }
}

void shim_windowed_lanes_k8(const int32_t *pts, const uint8_t *digits, int32_t *out, int S) {
  packed_slots<fe, K2_SPLIT>(pts, digits, out, S);
}

int shim_k2_split(void) { return K2_SPLIT; }

// K6 at split 1 (the TPU kernel's order) or K6_SPLIT; -1 for another split
int shim_windowed_lanes_k8_fe15(const int32_t *pts, const uint8_t *digits, int32_t *out, int S, int split) {
  if (split == 1) {
    packed_slots<fe15, 1>(pts, digits, out, S);
  } else if (split == K6_SPLIT) {
    packed_slots<fe15, K6_SPLIT>(pts, digits, out, S);
  } else {
    return -1;
  }
  return 0;
}

int shim_k6_split(void) { return K6_SPLIT; }

void shim_windowed_lanes(const int32_t *pts, const uint8_t *digits, int32_t *out, int N) {
  for (int i = 0; i < N; ++i) windowed_lane(out + 72 * i, pts, digits, N, i);
}

// K7 as daa_lanes.cu runs it, the quad of a lane in lockstep: each round
// for the four roles, then the exchange (every role reads the four results),
// then the end of the step; each role writes its coordinate
void shim_daa_lanes(const int32_t *pts, const int32_t *bits, int32_t *out, int N) {
  for (int i = 0; i < N; ++i) {
    ge acc[K7_QUAD], base[K7_QUAD];
    for (int r = 0; r < K7_QUAD; ++r) {
      ge_identity(acc[r]);
      ge_from_rows(base[r], pts + (size_t)i * 72);
    }
    for (int k = 0; k < 253; ++k) {
      const bool bit = daa_bit(bits, N, i, k);
      fe sqs[K7_QUAD], prs[K7_QUAD], dbls[K7_QUAD], adds[K7_QUAD];
      for (int r = 0; r < K7_QUAD; ++r) daa_round1(sqs[r], prs[r], acc[r], base[r], r);
      for (int r = 0; r < K7_QUAD; ++r) daa_round2(dbls[r], adds[r], sqs, prs, r);
      for (int r = 0; r < K7_QUAD; ++r) daa_step_end(acc[r], base[r], dbls, adds, bit);
    }
    for (int r = 0; r < K7_QUAD; ++r) daa_write(out + (size_t)i * 72, acc[r], r);
  }
}

int shim_k7_quad(void) { return K7_QUAD; }

// n field elements of 18 limbs each on the 15-bit tier: f * g by fe_mul, f^2
// by fe_sq, f - g by fe_sub, each as a canonical row
void shim_fe15(const int32_t *f, const int32_t *g, int32_t *out_mul, int32_t *out_sq,
               int32_t *out_sub, int n) {
  for (int i = 0; i < n; ++i) {
    fe15 a, b, r;
    fe_from_row15(a, f + 18 * i);
    fe_from_row15(b, g + 18 * i);
    fe_mul(r, a, b);
    fe_to_row15(out_mul + 18 * i, r);
    fe_sq(r, a);
    fe_to_row15(out_sq + 18 * i, r);
    fe_sub(r, a, b);
    fe_to_row15(out_sub + 18 * i, r);
  }
}

// the trees of tile_sums.cu, level by level: each sub-tile's, as its block
// runs it, then the partials' tree of a tile's last block
void shim_tile_sums(const int32_t *rows, int32_t *out, int n_tiles, int tile) {
  const int sub = tile < K3_SUB ? tile : K3_SUB, nsub = tile / sub;
  ge buf[32], parts[32];
  for (int b = 0; b < n_tiles; ++b) {
    for (int u = 0; u < nsub; ++u) {
      const int32_t *base = rows + ((size_t)b * nsub + u) * sub * 72;
      for (int t = 0; t < (sub > 1 ? sub / 2 : 1); ++t) buf[t] = tile_leaf(base, t, sub);
      for (int h = sub / 4; h >= 1; h >>= 1)
        for (int t = 0; t < h; ++t) tree_node(buf, t, h);
      parts[u] = buf[0];
    }
    for (int h = nsub / 2; h >= 1; h >>= 1)
      for (int t = 0; t < h; ++t) tree_node(parts, t, h);
    ge_to_rows(out + (size_t)b * 72, parts[0]);
  }
}

int shim_k3_sub(void) { return K3_SUB; }

// n field elements of 10 limbs each: out_mul = f * f by fe_mul, out_sq = f^2 by fe_sq
void shim_square(const uint32_t *f, uint32_t *out_mul, uint32_t *out_sq, int n) {
  for (int i = 0; i < n; ++i) {
    fe a, m, s;
    for (int k = 0; k < 10; ++k) a.v[k] = f[10 * i + k];
    fe_mul(m, a, a);
    fe_sq(s, a);
    for (int k = 0; k < 10; ++k) {
      out_mul[10 * i + k] = m.v[k];
      out_sq[10 * i + k] = s.v[k];
    }
  }
}

// One pass of K9 as bucket_sums.cu runs it: threads 0 .. first[nbk] - 1 one
// after the other, input point i rows[order[i]] (pass 1) or in[i]
void shim_bucket_pass(const int32_t *rows, const int32_t *order, const ge *in, const long long *start,
                      const long long *len, const long long *first, int nbk, int32_t *out, ge *blocks) {
  ge stack[K9_K + 1];
  const k9_input input = {rows, order, in};
  for (long long t = 0; t < first[nbk]; ++t) bucket_block(out, blocks, stack, t, start, len, first, nbk, input);
}

int shim_k9_k(void) { return K9_K; }

// K10's steps on a quad whose four roles run one after the other (the
// kernel's quad_steps without the gathers): the same rounds, so the same
// values and operations
struct quad_roles {
  void add(ge &a, const ge &b) const {
    fe pr[K7_QUAD], out[K7_QUAD];
    for (int r = 0; r < K7_QUAD; ++r) add_round1(pr[r], a, b, r);
    for (int r = 0; r < K7_QUAD; ++r) add_round2(out[r], pr, r);
    quad_point(a, out);
  }
  void add2(ge &a, const ge &b, ge &c, const ge &d) const {
    const ge before = d;  // round 1 reads d before a is written
    add(a, b);
    add(c, before);
  }
  void dbl(ge &p, bool want_t) const {
    fe sq[K7_QUAD], out[K7_QUAD];
    for (int r = 0; r < K7_QUAD; ++r) dbl_round1(sq[r], p, r);
    for (int r = 0; r < K7_QUAD; ++r) k10_dbl_round2(out[r], sq, p, r, want_t);
    quad_point(p, out);
  }
};

// window_sums.cu block_weighted over n items, its quads stepped between the
// block's barriers: (sum, total) of items tot[k], acc[k] of 2^log_s buckets
static void weighted_steps(std::vector<ge> tot, std::vector<ge> acc, int n, int log_s, ge &sum, ge &total) {
  const quad_roles steps;
  std::vector<ge> next(n);
  for (int s = 1; s < n; s <<= 1) {
    for (int k = 0; k < n; ++k) next[k] = suffix_node(tot.data(), k, s, n, steps);
    tot = next;
  }
  total = tot[0];
  ge_identity(tot[0]);
  for (int h = n / 2; h >= 1; h >>= 1)
    for (int k = 0; k < h; ++k) tot[k] = suffix_node(tot.data(), k, h, 2 * h, steps);
  ge x = tot[0];
  for (int h = n / 2; h >= 1; h >>= 1)
    for (int k = 0; k < h; ++k) acc[k] = suffix_node(acc.data(), k, h, 2 * h, steps);
  dbl_n(x, log_s, steps);
  sum = acc[0];
  steps.add(sum, x);
}

// K10 as window_sums.cu runs it at G pieces a window and Q quads a piece:
// each piece's quads step by step, the combine of each window's pieces,
// then the Horner chain, every step's roles one after the other
void shim_window_sums(const int32_t *buckets, int32_t *out, int W, int c, int G, int Q) {
  const quad_roles steps;
  int log_g = 0, log_q = 0;
  while ((1 << log_g) < G) ++log_g;
  while ((1 << log_q) < Q) ++log_q;
  const int log_p = c - log_g, log_m = log_p - log_q;
  std::vector<ge> sums(W), r(Q), acc(Q), piece_sum(G), piece_total(G);
  for (int w = W - 1; w >= 0; --w) {
    for (int g = 0; g < G; ++g) {
      for (int k = 0; k < Q; ++k)
        window_chunk(r[k], acc[k], buckets + (size_t)w * ((1 << c) - 1) * 72, g * Q + k, 1 << log_m, steps);
      weighted_steps(r, acc, Q, log_m, piece_sum[g], piece_total[g]);
    }
    ge total;
    if (G == 1) {
      sums[w] = piece_sum[0];
    } else {
      weighted_steps(piece_total, piece_sum, G, log_p, sums[w], total);
    }
  }
  ge total = sums[W - 1];
  for (int v = W - 2; v >= 0; --v) {
    dbl_n(total, c, steps);
    steps.add(total, sums[v]);
  }
  ge_to_rows(out, total);
}

// window_sums.cu k10_rounds_kernel: n times c doublings and one addition of
// p, from p
void shim_k10_rounds(const int32_t *p, int32_t *out, int c, int n) {
  const quad_roles steps;
  ge a;
  ge_from_rows(a, p);
  ge total = a;
  for (int i = 0; i < n; ++i) {
    dbl_n(total, c, steps);
    steps.add(total, a);
  }
  ge_to_rows(out, total);
}

int shim_k10_max_threads(void) { return K10_MAX_THREADS; }

// the 32 x 32 -> 64-bit products of one fe_mul (or fe_sq) on the radix-2^25.5
// tier or on fe15
unsigned long long shim_wide_products(int tier15, int square) {
  xhe_wide_count = 0;
  if (tier15) {
    fe15 a, h;
    fe_set_small(a, 3);
    square ? fe_sq(h, a) : fe_mul(h, a, a);
  } else {
    fe a, h;
    fe_set_small(a, 3);
    square ? fe_sq(h, a) : fe_mul(h, a, a);
  }
  return xhe_wide_count;
}

unsigned long long shim_mul_count(void) { return xhe_mul_count; }

unsigned long long shim_sq_count(void) { return xhe_sq_count; }

void shim_reset_mul_count(void) { xhe_mul_count = xhe_sq_count = 0; }
}
