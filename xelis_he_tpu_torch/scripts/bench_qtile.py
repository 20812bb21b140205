"""Block-width experiment for the field multiplication on the card (port
of scripts/bench_qtile.py).

    python -m xelis_he_tpu_torch.scripts.bench_qtile [--device cpu] [--lanes ...] [--target-ms 5]

1. fe15_mul_T128, _T256, _T512: K12 (_mul_t on 4 chains) at 128, 256 and
   512 threads a block, the H100's counterpart of the TPU script's tile
   widths (a Pallas tile of T lanes is a block of T threads here), in
   Mmul/s at the sweep's best lane count and at 16,384 lanes;
2. the quad kernel's QTILE sweep is not ported: QTILE is the lane width of
   the TPU kernel's tile, and K2 (csrc/windowed_lanes.cu) keeps its slots a
   block in the compile-time SLOTS = 32 with no launch argument.  A line
   says so.
"""

from __future__ import annotations

from ..ops import probes as PR
from . import _probe as B


def run(args, cache: dict | None = None, log=print) -> list[dict]:
    cache = {} if cache is None else cache
    info = B.card(args.device)
    out = []
    for block in PR.MUL15_BLOCKS:
        m = B.run_measure(cache, f"mul15_b{block}", args.device, args.lanes, args.target_ms, log)
        line = B.line(m, f"fe15_mul_T{block}", 1e6, "Mmul/s", block=block)
        line["Mmul_s"] = line.pop("value")  # the JAX script's key
        out.append(B.emit(line, info))
    out.append(B.emit({"metric": "quad_qtile_sweep", "ported": False,
                       "reason": "QTILE is the TPU kernel's tile width; K2 keeps SLOTS = 32 slots a block as a "
                                 "compile-time constant (csrc/windowed_lanes.cu), with no launch argument to sweep"},
                      info))
    return out


def main(argv=None) -> int:
    run(B.cli(__doc__.split("\n\n")[0], argv), log=lambda *a: print(*a, file=__import__("sys").stderr))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
