"""Multi-process runtime: torch.distributed bring-up, meshes, work fan-out.

Counterpart of ``zeth_tpu.parallel.multihost``. The reference brings up
one JAX distributed runtime per pod. PyTorch runs one process per rank:
every process calls ``init()`` (the rendezvous from its arguments or from
torchrun's environment), builds the ``rows`` mesh over every rank
(``pod_mesh``) and proves with ``zkp.prover.prove(..., mesh=...)``.

- **intra-proof**: ``pod_mesh()`` is a 1-D ``DeviceMesh`` over every rank;
  pass it to ``prover.prove`` or ``rv32im.prove_segments``. One proof,
  all ranks.
- **inter-proof**: ``shard_work(items)`` splits a work list (segments,
  blocks) round-robin by rank; each rank proves its share on its own
  card or its host's ranks (``local_mesh()``).

The backend follows the layout: NCCL where every rank of the host has a
card of its own, gloo where ranks share a card (NCCL refuses two ranks on
one GPU) or run on the CPU. ``launch`` spawns D ranks on this host, as
the tests, ``chip_smoke.py`` and ``tools/torch_mesh_prove.py`` run them.

A process with no rendezvous configured stays single: ``init()`` does
nothing and both meshes hold this process alone.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def backend_for(local_world: int, device=None) -> str:
    """``nccl`` when each of this host's `local_world` ranks has a card
    of its own (and the shards are not asked onto the CPU), else
    ``gloo``."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if (not on_cpu and torch.cuda.is_available()
            and local_world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, device=None) -> None:
    """Bring up the default process group from the arguments or from
    torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).
    `coordinator` is an init method (``tcp://host:port``,
    ``file:///path``). A no-op when none is configured or a group exists.
    `device="cpu"` keeps the ranks' shards on the CPU (gloo)."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = "env://"
    if coordinator is None or dist.is_initialized():
        return
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend_for(local_world, device)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=world, rank=rank)


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def _ensure_group() -> None:
    """A single process without a rendezvous gets a group of one."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(1), store=dist.HashStore(),
                                world_size=1, rank=0)


def _mesh_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def pod_mesh(axis: str = "rows"):
    """One 1-D mesh over every rank of the job."""
    from torch.distributed.device_mesh import DeviceMesh
    _ensure_group()
    return DeviceMesh(_mesh_type(), list(range(dist.get_world_size())),
                      mesh_dim_names=(axis,))


def local_mesh(axis: str = "rows"):
    """A 1-D mesh over this host's ranks only (inter-proof parallelism)."""
    from torch.distributed.device_mesh import DeviceMesh
    _ensure_group()
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host == world:
        return pod_mesh(axis)
    grid = torch.arange(world).reshape(world // per_host, per_host)
    return DeviceMesh(_mesh_type(), grid,
                      mesh_dim_names=("hosts", axis))[axis]


def shard_work(items: list) -> list:
    """This rank's share of a work list (round-robin by rank)."""
    if not dist.is_initialized():
        return list(items)
    pid, n = dist.get_rank(), dist.get_world_size()
    return [it for i, it in enumerate(items) if i % n == pid]


# -- a launcher for D ranks on this host -----------------------------------


def _rank_main(fn, args, rank: int, world: int, coordinator: str, device,
               threads: int, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(threads)
    try:
        init(coordinator, world, rank, device=device)
        out = fn(pod_mesh(), *args)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn, world: int, *args, device=None, threads: int = 1,
           timeout: float = 1800.0) -> list:
    """Run ``fn(mesh, *args)`` on `world` ranks of this host and return
    each rank's result, in rank order.

    The ranks are spawned processes (`fn` and its arguments are pickled:
    a module-level function of a module that imports quickly) that meet
    through a ``file://`` rendezvous in a fresh temporary directory, so
    concurrent launches never collide on a port. Each rank runs
    `threads` torch threads. `device="cpu"` puts the shards on the CPU
    (gloo); otherwise each rank proves on ``cuda:(rank % cards)``. A
    rank that raises, dies or outlives `timeout` makes this raise; every
    process it started is stopped before it returns."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        coordinator = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, coordinator, device,
                                   threads, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            deadline = time.time() + timeout
            while len(got) < world:
                try:
                    rank, ok, out = results.get(timeout=1.0)
                except queue.Empty:
                    lost = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if lost:
                        raise RuntimeError(
                            f"rank {lost[0]} exited with code "
                            f"{procs[lost[0]].exitcode} and no result")
                    if time.time() > deadline:
                        raise TimeoutError(f"{world} ranks ran past "
                                           f"{timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{out}")
                got[rank] = out
        finally:
            for p in procs:
                p.join(timeout=30 if len(got) == world else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(world)]
