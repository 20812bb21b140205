"""One process of a multi-process block verification.

    python -m xelis_he_tpu_torch.parallel._dcn_worker BLOCK COORDINATOR NUM_PROCESSES PROCESS_ID
        [--device cpu] [--tile N] [--qtile N]

BLOCK is a pickle of {"txs": [wire bytes], "ledger": carry.ledger_snapshot}.
The process joins the process group at COORDINATOR (host:port), loads its
own replica of the ledger, verifies its round-robin share of the block on an
Accelerator (the CUDA device unless --device cpu) and takes part in the
all-reduce that decides the block (``verify_batch_distributed`` in two
steps, so that the local outcome can be told).  It prints one JSON line with
its rank, share, verify time and the error that rejected its share (class
name and message, or null), then ACCEPT or REJECT, the same on every process.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("block")
    ap.add_argument("coordinator")
    ap.add_argument("num_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("--device", default=None, help="the Accelerator's device (default: the CUDA device)")
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--qtile", type=int, default=None)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..carry import ledger_from_snapshot, txs_from_wire
    from ..ops.accel import Accelerator
    from .dcn import all_reduce_accept, init_process, shard_round_robin, verify_share

    init_process(args.coordinator, args.num_processes, args.process_id)
    with open(args.block, "rb") as f:
        blob = pickle.load(f)
    state = ledger_from_snapshot(blob["ledger"])
    txs = txs_from_wire(blob["txs"])
    sizes = {k: v for k, v in (("tile", args.tile), ("qtile", args.qtile)) if v is not None}
    accel = Accelerator(device=args.device, **sizes)
    t0 = time.perf_counter()
    err = verify_share(txs, state, accel=accel)
    ok = all_reduce_accept(err is None)
    seconds = time.perf_counter() - t0
    share = len(shard_round_robin(txs, args.process_id, args.num_processes))
    error = None if err is None else {"class": type(err).__name__, "message": str(err)}
    print(json.dumps({"rank": args.process_id, "txs": share, "verify_s": seconds, "error": error}), flush=True)
    print("ACCEPT" if ok else "REJECT", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
