// Host build of xelis_he_tpu_torch/csrc/probes.cuh for the CPU tests: the
// lane bodies of the roofline probes K11-K14 run here one lane at a time,
// on the same (rows, T) layout as the kernels.
//   g++ -x c++ -DXHE_HD= -DXHE_NOINLINE= -O1 -shared -fPIC -I<csrc> this.cpp

#include "probes.cuh"

using namespace xhe;

extern "C" {

// form: 0 the u32 chain, 1 the 64-bit one, 2 the high word's (mad.hi)
int shim_probe_imad(const uint32_t *x, const uint32_t *y, uint32_t *out, int n, int reps, int form) {
  if (form < 0 || form > 2) return -1;
  for (int i = 0; i < n; ++i)
    out[i] = form == 1 ? probe_imad_wide(x[i], y[i], reps)
                       : form == 2 ? probe_imad_hi(x[i], y[i], reps) : probe_imad(x[i], y[i], reps);
  return 0;
}

void shim_probe_mul15(const uint32_t *x, const uint32_t *y, uint32_t *out, int T, int reps) {
  for (int t = 0; t < T; ++t) probe_mul15(out, x, y, T, t, reps);
}

int shim_probe_mul13(const uint32_t *x, const uint32_t *y, uint32_t *out, int T, int reps, int mode) {
  for (int t = 0; t < T; ++t) {
    if (mode == MUL13_3PASS)
      probe_mul13<MUL13_3PASS>(out, x, y, T, t, reps);
    else if (mode == MUL13_2PASS_CONSUMER)
      probe_mul13<MUL13_2PASS_CONSUMER>(out, x, y, T, t, reps);
    else if (mode == MUL13_2PASS)
      probe_mul13<MUL13_2PASS>(out, x, y, T, t, reps);
    else
      return -1;
  }
  return 0;
}

void shim_probe_fe(const uint32_t *x, const uint32_t *y, uint32_t *out, int T, int reps, int tier15, int square) {
  for (int t = 0; t < T; ++t) {
    if (tier15)
      square ? probe_fe<fe15, true>(out, x, y, T, t, reps) : probe_fe<fe15, false>(out, x, y, T, t, reps);
    else
      square ? probe_fe<fe, true>(out, x, y, T, t, reps) : probe_fe<fe, false>(out, x, y, T, t, reps);
  }
}
}
