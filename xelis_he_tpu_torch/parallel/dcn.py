"""Multi-process data parallelism: shard-nothing block verification.

The mesh axis (parallel.mesh, the Accelerator's ``mesh=``) shards the MSM
*lane* dimension inside one process; this axis shards the *transaction
batch* across processes.  Each process verifies its sub-batch of the block
against its own replica of the ledger (the reference's clone-per-worker
pattern), then one integer all-reduce over torch.distributed decides the
block: accepted iff every process verified its share.

Sharding policy: sub-batches must be closed under intra-block dependencies
(a tx spending an output of an earlier tx in the same block must land on
the same shard); ``shard_round_robin`` is correct for the common
independent-sender block shape, and callers with dependent txs group by
account first.

Multi-process usage (one process per card, or several sharing one):

    init_process(coordinator, num_processes, process_id)   # torch.distributed
    ok = verify_batch_distributed(all_txs, state, accel=accel)

``python -m xelis_he_tpu_torch.parallel._dcn_worker`` is such a process;
tests/test_torch_dcn.py runs two of them on the CPU over gloo.
"""

from __future__ import annotations

import torch

from ..tx.verify import verify_batch

AXIS = "dp"


def _backend(num_processes: int) -> str:
    """NCCL when every process of this host can have a card of its own;
    gloo on the CPU, or when processes share a card (NCCL refuses two ranks
    on one device)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def init_process(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the process group (call once per process, before
    ``verify_batch_distributed``).  ``coordinator_address`` is host:port of
    rank 0's rendezvous.  With NCCL, process i works on cuda:i."""
    import torch.distributed as dist

    backend = _backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def shard_round_robin(txs: list, process_index: int, num_processes: int) -> list:
    """Deterministic tx sub-batch for this process (independent-sender
    blocks; dependency-aware callers pre-group instead)."""
    return txs[process_index::num_processes]


def all_reduce_accept(local_ok: bool) -> bool:
    """Boolean AND across every process: each contributes 1 or 0 to one
    integer sum, which must equal the world size."""
    import torch.distributed as dist

    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    flag = torch.tensor([int(bool(local_ok))], dtype=torch.int64, device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.SUM)
    return int(flag.item()) == dist.get_world_size()


def verify_share(
    txs: list,
    state,
    accel=None,
    process_index: int | None = None,
    num_processes: int | None = None,
) -> Exception | None:
    """Verify this process's round-robin share of ``txs`` against
    ``state``, its replica; the exception that rejected the share, or None.
    ``accel`` is ``verify_batch``'s: None is ``default_accelerator()``, the
    card, resolved before any share is verified (it raises without one);
    ``"host"`` the reference's host path.  Rank and world size default to
    torch.distributed's."""
    import torch.distributed as dist

    from ..ops.accel import resolve_accel

    accel = resolve_accel(accel)
    if process_index is None:
        process_index = dist.get_rank()
    if num_processes is None:
        num_processes = dist.get_world_size()

    local = shard_round_robin(txs, process_index, num_processes)
    if local:
        try:
            verify_batch(local, state, accel=accel)
        except Exception as exc:
            return exc
    return None


def verify_batch_distributed(
    txs: list,
    state,
    accel=None,
    process_index: int | None = None,
    num_processes: int | None = None,
) -> bool:
    """Verify ``txs`` sharded across processes; True iff EVERY shard
    verified.  ``state`` is this process's replica (mutated by its own
    shard only, the reference's clone-per-worker semantics); ``accel`` is
    ``verify_share``'s (None: the card).  A shard whose
    verification raises counts as rejected, as in the JAX package
    (``verify_share`` returns what it raised)."""
    return all_reduce_accept(verify_share(txs, state, accel, process_index, num_processes) is None)
