"""Kernel roofline on the card: field operations a second against the
measured integer multiply-add rate (port of scripts/bench_roofline.py).

    python -m xelis_he_tpu_torch.scripts.bench_roofline [--device cpu] [--lanes 1024,16384] [--target-ms 5]

One JSON line a metric, under the JAX script's names, each with the card's
name and power limit:
  1. vpu_u32_mul_per_sec: K11's x = x y + 1 on 4 chains, the card's u32
     multiply-add rate (Gmul/s), beside 132 SMs x 64 INT32 lanes x the max
     SM clock; vpu_u32_mul_per_sec_wide: the same chain as a 32 x 32 ->
     64-bit multiply-add, and the issue slots a wide one takes;
     vpu_u32_mulhi_per_sec: the chain as the high word's multiply-add
     (mad.hi.u32), and the issue slots one takes;
  2. field_muls_per_sec_chip: K12, the JAX kernels' 18 x 15-bit _mul_t
     (in its column-sum form);
     field_muls_per_sec_chip_fe13: K13, their 20 x 13-bit _mul13;
  3. port_{fe,fe15}_{mul,sq}_per_sec: K14, the port's own field
     multiplication and squaring on its two tiers;
  4. msm_windowed_pts_per_sec (K5 at 262,144 lanes) and
     msm_quad_pts_per_sec (K2 at 16,384 slots of 8): points a second, and
     the share of the rate that (3)'s measured rates predict from each
     kernel's field operations.
Rates are the sweep's best (its plateau), with the rate at the TPU script's
16,384 lanes beside it.  Every launch is held to its plain version.
"""

from __future__ import annotations

from ..ops import kernels as K
from ..ops import probes as PR
from . import _probe as B

LABELS = ("imad", "imad_wide", "imad_hi", "mul15_b256", "mul13_3pass", "fe_mul", "fe_sq", "fe15_mul", "fe15_sq")


def run(args, cache: dict | None = None, log=print) -> list[dict]:
    cache = {} if cache is None else cache
    info = B.card(args.device)
    m = {k: B.run_measure(cache, k, args.device, args.lanes, args.target_ms, log)
         for k in LABELS}
    peak = m["imad"]["peak"]["muladds_per_s"]
    theory = B.INT32_LANES * info["max_sm_mhz"] * 1e6 if "max_sm_mhz" in info else None
    out = [B.emit(B.line(m["imad"], "vpu_u32_mul_per_sec", 1e9, "Gmul/s",
                         pct_of_theoretical=100.0 * peak / theory if theory else None,
                         note="x = x y + 1 on 4 chains, an element a thread; theoretical: 132 SMs x 64 INT32 "
                              "lanes x max SM clock"), info)]
    wide = m["imad_wide"]["peak"]["muladds_per_s"]
    out.append(B.emit(B.line(m["imad_wide"], "vpu_u32_mul_per_sec_wide", 1e9, "Gmul/s",
                             slots_per_wide=peak / wide,
                             note="acc = lo(acc) y + acc, 64-bit: one 32x32->64 multiply-add a step"), info))
    hi = m["imad_hi"]["peak"]["muladds_per_s"]
    out.append(B.emit(B.line(m["imad_hi"], "vpu_u32_mulhi_per_sec", 1e9, "Gmul/s", slots_per_hi=peak / hi,
                             note="x = hi32(x y) + x: one mad.hi.u32 a step"), info))
    fm = m["mul15_b256"]["peak"]["ops_per_s"]
    out.append(B.emit(B.line(m["mul15_b256"], "field_muls_per_sec_chip", 1e6, "Mmul/s",
                             pct_of_u32_bound=100.0 * fm * PR.MULADDS_MUL_T / peak,
                             note="18x15-bit _mul_t: 324 products, 20 constant multiplies, as column sums"),
                      info))
    fm13 = m["mul13_3pass"]["peak"]["ops_per_s"]
    out.append(B.emit(B.line(m["mul13_3pass"], "field_muls_per_sec_chip_fe13", 1e6, "Mmul/s", vs_fe15=fm13 / fm,
                             pct_of_u32_bound=100.0 * fm13 * PR.MULADDS_MUL13["3pass"] / peak,
                             note="20x13-bit _mul13, 3-pass carry"), info))
    for label in ("fe_mul", "fe_sq", "fe15_mul", "fe15_sq"):
        p = B.PROBES[label]
        rate = m[label]["peak"]["ops_per_s"]
        out.append(B.emit(B.line(m[label], f"port_{label}_per_sec", 1e6, "Mmul/s",
                                 pct_of_u32_bound=100.0 * rate * PR.fe_muladds(p.tier, p.square) / peak,
                                 note=f"the port's {'fe_sq' if p.square else 'fe_mul'} on "
                                      f"{'fe15 (18 x 15-bit, 64-bit columns)' if p.tier == 'fe15' else 'radix 2^25.5'}"),
                          info))
    ends = B.end_kernels(args.device, ("windowed_lanes", "windowed_lanes_k8"), B.fe_rates(m), peak,
                         args.end_lanes, args.end_slots, log)
    for name, metric, note in (("windowed_lanes", "msm_windowed_pts_per_sec", "K5, a scalar-mul a lane"),
                               ("windowed_lanes_k8", "msm_quad_pts_per_sec",
                                "K2, 8 scalar-muls a slot: the engine the default verify runs")):
        r = ends[name]
        out.append(B.emit({"metric": metric, "value": r["pts_per_s"] / 1e6, "unit": "Mpts/s", "n": r["n"],
                           "ms": r["ms"], "field_muls": r["field_muls"], "field_sqs": r["field_sqs"],
                           **{k: r[k] for k in ("pct_of_field_mul_prediction", "pct_of_executed_prediction",
                                                "pct_of_measured_peak") if k in r},
                           "note": note}, info))
    return out


def main(argv=None) -> int:
    run(B.cli(__doc__.split("\n\n")[0], argv), log=lambda *a: print(*a, file=__import__("sys").stderr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
