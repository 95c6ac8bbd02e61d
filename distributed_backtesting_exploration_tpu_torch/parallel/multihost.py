"""Multi-process scale-out: the ``torch.distributed`` process group and the
host-sharded work list (the reference's ``parallel/multihost.py``).

Two layers scale the system past one host, as in the reference:

1. **Job level (the default).** Each host runs its own worker against the
   dispatcher (:mod:`..rpc.worker`); nothing is coordinated between them.
2. **Slice level.** The processes of a slice form one process group
   (:func:`initialize`) and serve the dispatcher as one worker
   (:mod:`..rpc.slice_worker`). Each process computes on its own local
   :class:`~.sharding.Mesh`; the group carries only host buffers between
   them (the leader's decoded job groups out, the finished result blocks
   back), so it is a gloo group. Device work never crosses a process.

NCCL would carry device buffers between processes; nothing here needs it,
and it could not be measured on a machine with one card.
"""

from __future__ import annotations

import logging
import os

import torch.distributed as dist

log = logging.getLogger("dbx.torch.multihost")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None) -> int:
    """Join the slice's gloo process group; returns the world size.

    With no arguments and no cluster environment (``WORLD_SIZE`` unset or
    1) this is a no-op that returns 1. Otherwise it calls
    ``torch.distributed.init_process_group("gloo", ...)`` with
    ``init_method`` (default ``env://``, which reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``), e.g.

        initialize("tcp://host0:29500", world_size=2, rank=0)

    and raises ``RuntimeError`` where the world it joined is not the world
    it was asked for: a process that went on alone would redo the whole
    work list. Idempotent in a process."""
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if (init_method is None and world_size is None and rank is None
            and env_world <= 1):
        log.info("multihost: single-process mode (no process group "
                 "configured)")
        return 1
    want = world_size if world_size is not None else env_world
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=init_method or "env://",
                                world_size=-1 if world_size is None
                                else world_size,
                                rank=-1 if rank is None else rank)
    got = dist.get_world_size()
    if got != want:
        raise RuntimeError(
            f"multihost: joined a process group of {got} processes, "
            f"expected {want}")
    log.info("multihost: process %d/%d", dist.get_rank(), got)
    return got


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_shard(n_items: int) -> slice:
    """This process's contiguous shard of a length-``n_items`` work list:
    every process computes the same split and takes its slice."""
    pid, n = process_index(), process_count()
    per = -(-n_items // n)
    return slice(min(pid * per, n_items), min((pid + 1) * per, n_items))
