"""Data parallelism over processes (the port of sqair_tpu/parallel/mesh.py).

The parameters are replicated, the batch (with its IWAE particles) is
split over the processes, and each process runs the kernels on its own
rows: JAX's ``shard_map`` strategy, which is what runs on the TPU whenever
its kernels are on.  Each step:

  1. every process takes its rows of the same global batch and runs the
     train-record loss forward and backward with its own noise (the
     counterpart of ``fold_in(rng, shard_index)``);
  2. the gradients, flattened into one buffer in the parameters' order,
     are summed over the processes and divided by their number; the
     metrics the same way, and then ``Model.finalize_metrics`` turns the
     aspect ratio's parts into the global ratio;
  3. every process takes the same optimizer step.

A multislice mesh (``make_multislice_mesh``) reduces through two groups,
the processes of a slice first, then one process of each slice (ICI
first, DCN once).

JAX's other strategy, GSPMD (one global program that XLA partitions, the
gradient all-reduce inserted by the compiler), has no counterpart here:
torch runs one program per process.

Usage (every process):

    initialize(address, world, rank)
    mesh = make_mesh()
    step = make_parallel_train_step(model, optimizer, mesh)
    metrics = step(obs, nums, noise)   # the global batch; this rank's noise
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from ..models.model import Model
from ..ops.noise import NoiseSource
from ..training.train import TrainState, init_train

DATA_AXIS = "data"


class Mesh:
    """The processes that a batch is split over.

    :param groups: the process groups that a sum goes through, in order
        (``None``: the world group)
    :param rank: this process's shard of the batch
    :param size: the number of shards
    """

    def __init__(self, groups: Sequence, rank: int, size: int):
        import torch.distributed as dist

        self.groups, self.rank, self.size = list(groups), int(rank), int(size)
        self.backend = dist.get_backend()
        # small tensors of the host's votes and counts live here
        self.flag_device = (torch.device("cuda", torch.cuda.current_device())
                            if self.backend == "nccl" else torch.device("cpu"))

    def _all_reduce_(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced over the processes in place, through each group in
        turn.  gloo reduces a card's tensor in a host copy (as gloo itself
        would stage it)."""
        import torch.distributed as dist

        host = t.cpu() if t.is_cuda and self.backend != "nccl" else t
        for group in self.groups:
            dist.all_reduce(host, op=op, group=group)
        if host is not t:
            t.copy_(host)
        return t

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``x`` summed over the processes."""
        import torch.distributed as dist

        return self._all_reduce_(x.detach().clone(), dist.ReduceOp.SUM)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` in every process, in place."""
        import torch.distributed as dist

        host = t.cpu() if t.is_cuda and self.backend != "nccl" else t
        dist.broadcast(host, src=0)
        if host is not t:
            t.copy_(host)
        return t

    def mean_(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Replaces each tensor with its mean over the processes, in one
        flat buffer (the tensors' order fixes the buffer's layout, the same
        in every process)."""
        import torch.distributed as dist

        if not tensors:
            return tensors
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        self._all_reduce_(flat, dist.ReduceOp.SUM).div_(self.size)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
        return tensors

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The metrics' means over the processes (keys in sorted order)."""
        keys = sorted(metrics)
        values = [metrics[k].detach().clone() for k in keys]
        return dict(zip(keys, self.mean_(values)))

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds in any process (a MAX over them)."""
        import torch.distributed as dist

        t = torch.tensor([1.0 if flag else 0.0], device=self.flag_device)
        return bool(self._all_reduce_(t, dist.ReduceOp.MAX).item() > 0.0)

    def shard(self, x, time_major: bool = True):
        """This process's rows of ``x``'s batch axis (axis 1 time-major,
        else 0): rows [rank B/W, (rank + 1) B/W)."""
        axis = 1 if time_major else 0
        B = x.shape[axis]
        if B % self.size:
            raise ValueError(f"batch of {B} not divisible over the {self.size} processes of "
                             "the data mesh")
        n = B // self.size
        return x[(slice(None),) * axis + (slice(self.rank * n, (self.rank + 1) * n),)]


def make_mesh(group=None) -> Mesh:
    """The mesh of every process of ``group`` (default: the world)."""
    import torch.distributed as dist

    return Mesh([group], dist.get_rank(group), dist.get_world_size(group))


def make_multislice_mesh(n_slices: int) -> Mesh:
    """A 2-D (dcn, data) mesh: the world's processes in ``n_slices`` slices
    of consecutive ranks.  A sum goes over the slice's processes first,
    then over the processes at the same place in every slice; a process's
    shard is its rank (slice index x slice size + place).  Every process
    must call this, with the same ``n_slices`` (each group is made by all)."""
    import torch.distributed as dist

    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_slices:
        raise ValueError(f"{world} processes not divisible into {n_slices} slices")
    per = world // n_slices
    intra = inter = None
    for s in range(n_slices):
        g = dist.new_group(list(range(s * per, (s + 1) * per)))
        if rank // per == s:
            intra = g
    for p in range(per):
        g = dist.new_group([s * per + p for s in range(n_slices)])
        if rank % per == p:
            inter = g
    return Mesh([intra, inter], rank, world)


def replicated(mesh: Mesh) -> Callable:
    """A value that every process holds whole: its part is itself."""
    return lambda x: x


def batch_sharded(mesh: Mesh, time_major: bool = True) -> Callable:
    """[T, B, ...] split on B (or [B, ...] on axis 0): x -> this process's rows."""
    return lambda x: mesh.shard(x, time_major)


def shard_batch(batch, mesh: Mesh, time_major: bool = True):
    """This process's rows of a batch: a tensor, an array, or a dict or
    tuple of them."""
    take = batch_sharded(mesh, time_major)
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def _local(model: Model, mesh: Mesh, obs, nums):
    device, dtype = model.device, model.dtype
    obs, nums = shard_batch((obs, nums), mesh)
    return (torch.as_tensor(obs, dtype=dtype, device=device),
            torch.as_tensor(nums, dtype=dtype, device=device))


def make_parallel_train_step(model: Model, optimizer, mesh: Mesh,
                             l2_weight: float = 0.0) -> Callable:
    """(obs [T, B, H, W], nums [T, B, C], noise) -> metrics: one train step
    on this process's rows of the global batch ``obs``, ``nums`` and with
    its ``noise``; the mean gradient over the processes updates the
    parameters in place.  The metrics, the same in every process, are the
    means over them, finalized (those of the parameters before the update).

    :param optimizer: a factory from ``make_optimizer``, or a
        ``TrainState`` bound to the model's parameters (``init_train``)
    """
    state = optimizer if isinstance(optimizer, TrainState) else init_train(model, optimizer)
    params = list(model.sequence.parameters())

    def train_step(obs, nums, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        obs, nums = _local(model, mesh, obs, nums)
        state.optimizer.zero_grad(set_to_none=True)
        target, aux = model.loss_and_metrics(obs, noise, nums, l2_weight=l2_weight,
                                             record_mode="train", group=mesh)
        target.backward()
        with torch.no_grad():
            mesh.mean_([p.grad for p in params if p.grad is not None])
            metrics = mesh.mean_metrics(aux["metrics"])
        state.optimizer.step()
        state.step += 1
        return Model.finalize_metrics(metrics)

    train_step.state = state
    return train_step


def make_parallel_eval_step(model: Model, mesh: Mesh) -> Callable:
    """(obs [T, B, H, W], nums [T, B, C], noise) -> the metrics of the global
    batch: each process evaluates its rows with its noise under
    ``torch.inference_mode``; the means over the processes, finalized."""

    def eval_step(obs, nums, noise: NoiseSource) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            obs, nums = _local(model, mesh, obs, nums)
            _, aux = model.loss_and_metrics(obs, noise, nums, group=mesh)
            return Model.finalize_metrics(mesh.mean_metrics(aux["metrics"]))

    return eval_step
