"""The collectives of the multi-device path, with their cost.

Every exchange of the sharded prover goes through these few functions
over the ``rows`` group of a ``DeviceMesh``, with the shards' own tensors:
NCCL takes card tensors where each rank has a card; gloo, where ranks
share a card (NCCL refuses two ranks on one GPU), takes the card tensors
too (PyTorch 2.11's gloo copies them through host memory itself) and CPU
tensors on the CPU. ``transport`` names what carried a tensor's bytes.

Each call adds its bytes and seconds to ``STATS`` (per operation: calls,
bytes this rank handed to the collective, host seconds from the
synchronise before it to the synchronise after it).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# op -> [calls, bytes, seconds] of this process since the last reset
STATS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def group_of(mesh):
    """The process group of a 1-D mesh's ``rows`` dimension."""
    return mesh.get_group("rows")


def size(mesh) -> int:
    return mesh.size()


def rank(mesh) -> int:
    return mesh.get_local_rank("rows")


def transport(mesh, device) -> str:
    """What carries the bytes of a collective on tensors on `device`."""
    backend = dist.get_backend(group_of(mesh))
    if backend == "gloo" and torch.device(device).type == "cuda":
        return "gloo on card tensors, through host memory"
    return f"{backend} on {torch.device(device).type} tensors"


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class _Timed:
    """Adds one call of `op` on tensor `t` (its bytes) to STATS, with the
    seconds between a device synchronise before and after it."""

    def __init__(self, op: str, t: torch.Tensor):
        self.op = op
        self.t = t

    def __enter__(self):
        _sync(self.t)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _sync(self.t)
        ent = STATS.setdefault(self.op, [0, 0, 0.0])
        ent[0] += 1
        ent[1] += self.t.numel() * self.t.element_size()
        ent[2] += time.perf_counter() - self.t0


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """x: (D, ...) on every rank; out[j] = rank j's x[this rank]."""
    group = group_of(mesh)
    x = x.contiguous()
    with _Timed("all_to_all", x):
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """(D,) + x.shape: every rank's x, in rank order, on every rank."""
    group = group_of(mesh)
    x = x.contiguous()
    d = size(mesh)
    with _Timed("all_gather", x):
        parts = [torch.empty_like(x) for _ in range(d)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise sum of every rank's x (x is not modified)."""
    group = group_of(mesh)
    with _Timed("all_reduce", x):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y


def broadcast_object(obj, mesh, src: int = 0):
    """`obj` of rank `src` (in the mesh), on every rank."""
    group = group_of(mesh)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, src),
                               group=group)
    return box[0]
