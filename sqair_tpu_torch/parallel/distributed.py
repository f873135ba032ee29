"""The multi-process runtime of the data mesh (the port of
sqair_tpu/parallel/distributed.py).

Every process runs the same program and calls ``initialize(...)`` once,
before it builds a tensor.  Each process holds the same global batch (the
data pipeline is seeded alike everywhere) and takes its own rows of it
(``global_shard_batch``); rank 0's parameters and optimizer state are
copied to every process once, after init or restore
(``replicate_to_mesh``).  Each process draws its own noise, from a
generator seeded with ``rank_seed(seed, rank)``: the counterpart of the
JAX package's ``fold_in(rng, shard_index)``.

On the card the collectives are NCCL's, one process a card; on the CPU
gloo's.  A caller may name the backend, e.g. gloo for several processes
that share one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
from typing import Optional

import torch

from .mesh import Mesh, shard_batch

# seeds of the processes' generators lie this far apart
RANK_SEED_STRIDE = 1 << 20


def rank_seed(seed: int, rank: int) -> int:
    """The seed of process ``rank``'s noise generator: ``seed`` itself at
    rank 0, so that a run of one process draws what a single-process run
    does."""
    return int(seed) + RANK_SEED_STRIDE * int(rank)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda",
               timeout_s: Optional[float] = None) -> bool:
    """Joins the process group; returns True if it did.

    Does nothing (returns False) when ``coordinator_address`` is empty: the
    single-process path stays as it is.

    :param coordinator_address: host:port of process 0 (or a full init
        method, e.g. ``tcp://host:port``)
    :param backend: NCCL where ``device`` is a CUDA device, gloo on the CPU,
        unless named here
    :param device: where the process computes; on CUDA, a process with no
        device index takes card ``process_id`` modulo the cards it sees
    :param timeout_s: how long a collective may wait for its peers (torch's
        default unless given)
    """
    if not coordinator_address:
        return False
    import torch.distributed as dist

    world, rank = int(num_processes or 1), int(process_id or 0)
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is not one of the {world} processes")

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend or default_backend(device), init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    # every process meets here, right after init, while they are still in
    # step (JAX's sync_global_devices("sqair_tpu:init"))
    barrier()
    return True


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_initialized() else 1


def barrier():
    """Waits for every process (none to wait for without a process group)."""
    import torch.distributed as dist

    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown():
    """Leaves the process group, if there is one."""
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()


# every process passes the SAME global batch and gets its own rows
global_shard_batch = shard_batch


def replicate_to_mesh(module: torch.nn.Module, mesh: Mesh, optimizer=None):
    """Copies rank 0's parameters and buffers and, given an optimizer bound
    to them, its state and step count to every process, in place.

    Every process must hold the same structure: the same model, and
    optimizer state for the same parameters (none before the first step,
    or all of a restored checkpoint's)."""
    with torch.no_grad():
        for t in module.state_dict().values():
            mesh.broadcast_(t)
        if optimizer is not None:
            for p in module.parameters():
                for k in sorted(optimizer.state.get(p, {})):
                    mesh.broadcast_(optimizer.state[p][k])
            count = torch.tensor([int(optimizer.count)], dtype=torch.int64,
                                 device=mesh.flag_device)
            optimizer.count = int(mesh.broadcast_(count).item())
