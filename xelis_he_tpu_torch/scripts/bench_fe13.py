"""The 13-bit tier's carry variants on the card (port of scripts/bench_fe13.py).

    python -m xelis_he_tpu_torch.scripts.bench_fe13 [--device cpu] [--lanes ...] [--target-ms 5]

One JSON line a metric, under the JAX script's names, each with the card's
name and power limit:
  1. fe13_mul_3pass: K13's _mul13 (the landed 3-pass carry);
  2. fe13_mul_2pass_plus_consumer: the deferred 2-pass form with the
     consumer's _carry13 charged to it;
  3. fe13_mul_2pass_only: the 2-pass form alone;
  4. fe15_mul_prod: K12, the 18 x 15-bit _mul_t, for reference;
  5. quad_kernel_fe13=0 and =1: the packed-lanes kernel on the 15-bit tier
     (K6) and on the default one (K2) at 16,384 slots of 8, points a
     second, each beside the rate its tier's measured field operations
     (K14) predict.  On the card the default tier is the port's radix
     2^25.5, not the TPU's 13 bits: quad_kernel_fe13=1 is K2, the kernel
     the switch picks.
Each variant's rate is Mmul/s at the sweep's best lane count, with the rate
at the TPU script's 16,384 lanes beside it.
"""

from __future__ import annotations

from . import _probe as B

VARIANTS = (("mul13_3pass", "fe13_mul_3pass"), ("mul13_2pass_consumer", "fe13_mul_2pass_plus_consumer"),
            ("mul13_2pass", "fe13_mul_2pass_only"), ("mul15_b256", "fe15_mul_prod"))


def run(args, cache: dict | None = None, log=print) -> list[dict]:
    cache = {} if cache is None else cache
    info = B.card(args.device)
    measure = lambda k: B.run_measure(cache, k, args.device, args.lanes, args.target_ms, log)  # noqa: E731
    out = []
    for label, metric in VARIANTS:
        m = measure(label)
        line = B.line(m, metric, 1e6, "Mmul/s")
        line["Mmul_s"] = line.pop("value")  # the JAX script's key
        out.append(B.emit(line, info))
    m = {k: measure(k) for k in ("imad", "fe_mul", "fe_sq", "fe15_mul", "fe15_sq")}
    ends = B.end_kernels(args.device, ("windowed_lanes_k8_fe15", "windowed_lanes_k8"), B.fe_rates(m),
                         m["imad"]["peak"]["muladds_per_s"], args.end_lanes, args.end_slots, log)
    for tag, name in (("0", "windowed_lanes_k8_fe15"), ("1", "windowed_lanes_k8")):
        r = ends[name]
        out.append(B.emit({"metric": f"quad_kernel_fe13={tag}", "kpts_s": r["pts_per_s"] / 1e3, "n": r["n"],
                           "ms": r["ms"], "kernel": "K6" if tag == "0" else "K2",
                           **{k: r[k] for k in ("pct_of_field_mul_prediction", "pct_of_executed_prediction",
                                                "pct_of_measured_peak")}}, info))
    return out


def main(argv=None) -> int:
    run(B.cli(__doc__.split("\n\n")[0], argv), log=lambda *a: print(*a, file=__import__("sys").stderr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
