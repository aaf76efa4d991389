"""Prove EVM segment 0 over several ranks of one card, against the unsharded prove.

    python3 tools/torch_mesh_prove.py [--ranks D]

The stateless-client guest validates the smaller fixture block (built and
run as ``chip_smoke.py`` phase 6 does) and its segment 0 is proved at
po2=20 with its paging proof: first unsharded by ``rv32im.prove_segments``
on the card (``chip_smoke.py`` phase 8's path), then by D ranks (default
2) with ``prove_segments(mesh=...)``, each rank a process of its own
(``parallel.multihost.launch``) with its shards on ``cuda:(rank %
cards)``: with one card every rank shares it, over gloo. Every rank's
seals must equal the unsharded seals word for word, and they must verify
(``chip_smoke.verify_pair``). The ranks prove first, then this process
alone. Both proves run with the prover's stage timers on. Prints the
card; for the unsharded prove and for each rank:
the prove seconds, each stage's seconds, the peak device memory and the
process's peak host RSS; for each rank the calls, bytes and seconds of
each collective and what carried them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _rss_gib() -> float:
    """This process's peak resident host memory (Linux reports KiB). A
    spawned process starts from its parent's peak, so the ranks are
    spawned before the parent proves anything, and the parent's peak at
    that point is printed beside theirs."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _staged(prove, dev) -> dict:
    """One prove with the stage timers on: seconds, stages, peak."""
    import torch

    from zeth_tpu_torch.zkp import prover
    prover.TIMING = True
    prover.STAGE_LOG.clear()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    seals, pg_seals = prove()
    torch.cuda.synchronize(dev)
    return {"s": time.time() - t0, "seals": (seals[0], pg_seals[0]),
            "stages": list(prover.STAGE_LOG),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def rank_prove(mesh, seg, ia, iw) -> dict:
    """One rank: segment 0 proved with ``prove_segments(mesh=...)``."""
    import torch.distributed as dist

    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.convert import resolve_device
    from zeth_tpu_torch.parallel import comm
    dev = resolve_device(None, mesh)
    kernels.load("poseidon2_leaf")
    comm.reset_stats()
    dist.barrier()
    out = _staged(lambda: rv32im.prove_segments([seg], ia, iw, mesh=mesh),
                  dev)
    out.update(rank=comm.rank(mesh), device=str(dev), rss_gib=_rss_gib(),
               comm=dict(comm.STATS), transport=comm.transport(mesh, dev))
    return out


def _stage_line(stages) -> str:
    return "; ".join(f"{name.strip()} {dt:.3f}" for name, dt in stages)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_prove: no CUDA device")
    import chip_smoke as CS
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.parallel import multihost
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    print(f"[mesh-prove] {card}; torch {torch.__version__}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    kernels.build_all()
    seg, ia, iw, _, _ = CS.evm_segment()
    po2 = rv32im.choose_po2(seg, len(ia))
    spawn_rss = _rss_gib()
    t0 = time.time()
    ranks = multihost.launch(rank_prove, args.ranks, seg, ia, iw,
                             threads=max(1, (os.cpu_count() or 8)
                                         // args.ranks),
                             timeout=1800)
    wall = time.time() - t0
    one = _staged(lambda: rv32im.prove_segments([seg], ia, iw, device=dev),
                  dev)
    print(f"{card} | [mesh-prove] unsharded po2={po2}: prove_segments "
          f"{one['s']:.3f} s, peak device memory {one['peak_gib']:.2f} GiB, "
          f"host RSS {_rss_gib():.2f} GiB (this process, {spawn_rss:.2f} "
          f"GiB when it spawned the ranks); stages (s): "
          f"{_stage_line(one['stages'])}", flush=True)
    for r in ranks:
        moved = ", ".join(f"{op} {c} calls {b / 2**20:.2f} MiB {t:.3f} s"
                          for op, (c, b, t) in sorted(r["comm"].items()))
        print(f"{card} | [mesh-prove] rank {r['rank']} of {args.ranks} on "
              f"{r['device']}: prove_segments {r['s']:.3f} s, peak device "
              f"memory {r['peak_gib']:.2f} GiB, host RSS {r['rss_gib']:.2f} "
              f"GiB; collectives ({r['transport']}): {moved}; stages (s): "
              f"{_stage_line(r['stages'])}", flush=True)
        if not all(np.array_equal(a, b)
                   for a, b in zip(r["seals"], one["seals"])):
            raise SystemExit(f"rank {r['rank']}'s seals differ from the "
                             "unsharded seals")
    pg_s, rv_s = CS.verify_pair(dev, *ranks[0]["seals"], ia, iw)
    print(f"{card} | [mesh-prove] every rank's seals equal the unsharded "
          f"seals word for word; verified ({pg_s:.3f} s paging + "
          f"{rv_s:.3f} s rv32im); the ranks' launch {wall:.3f} s with start-up",
          flush=True)


if __name__ == "__main__":
    main()
