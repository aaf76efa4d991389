"""Prove one of the main paths on the card with the prover's stage timers.

    python3 tools/torch_stages.py [--path evm|spin|bigint] [--repeat N]
                                  [--tree DIR]

``evm``: the stateless-client guest validates the smaller fixture block
(as ``chip_smoke.py`` phase 6 builds and runs it) and segment 0 (po2=20)
is proved with its paging proof by ``rv32im.prove_segments``. ``spin``:
``chip_smoke.py``'s halting spin segment (``SPIN_PO2``), by
``rv32im.prove_segment``. ``bigint``: the block's bigint batch (every
bigint call of that execution, po2=15), by ``bigint2.prove_batch``. Each
prove runs `--repeat` times (the first one in the process also pays the
kernels' build and the card's warm-up) with ``prover.TIMING`` on. Prints
the card, and for each prove its seconds, the peak device memory, every
stage with its seconds, the peak so far at the end of each stage that
synchronises the card (``prover.STAGE_PEAKS``), the first of those
that reached the peak, and the process's peak host RSS so far
(``ru_maxrss``). ``--tree`` imports ``zeth_tpu_torch`` from another
checkout (for example an unpacked parent commit), so two versions of the
package can be measured in one call on one card; ``chip_smoke``'s
helpers and the fixture block come from ``--tree`` too where it holds
them. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _prover(path: str, dev):
    """A no-argument function that proves `path` once on `dev`."""
    import chip_smoke as CS
    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.circuits import rv32im
    if path == "spin":
        seg, ia, iw, _, _ = CS.spin_segment(
            ((1 << CS.SPIN_PO2) - 4096) * 3 // 2, CS.SPIN_PO2)
        return lambda: rv32im.prove_segment(seg, ia, iw, device=dev)
    seg, ia, iw, _, ex = CS.evm_segment()
    if path == "evm":
        return lambda: rv32im.prove_segments([seg], ia, iw, device=dev)
    args = zkvm.accelerator_batches(ex)["bigint"]
    mod = zkvm.accelerator_module("bigint")
    return lambda: mod.prove_batch(*args, device=dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["evm", "spin", "bigint"],
                    default="evm")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import zeth_tpu_torch from")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_stages: no CUDA device")
    import chip_smoke as CS
    import zeth_tpu_torch
    from zeth_tpu_torch.zkp import prover
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(zeth_tpu_torch.__file__))) == tree
    dev = torch.device("cuda", 0)
    card = CS.card_line()
    prove = _prover(args.path, dev)
    for run in range(1, args.repeat + 1):
        prover.TIMING = True
        prover.STAGE_LOG.clear()
        prover.STAGE_PEAKS.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        total = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        prover.TIMING = False
        tag = (f"{card} | [{args.path}-stages "
               f"{os.path.relpath(tree, ROOT)} run {run}]")
        for name, dt in prover.STAGE_LOG:
            print(f"{tag} {name.strip()}: {dt:.3f} s", flush=True)
        for name, so_far in prover.STAGE_PEAKS:
            print(f"{tag} peak so far at the end of '{name.strip()}': "
                  f"{so_far / 2**30:.2f} GiB", flush=True)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # KiB
        setter = next((name for name, b in prover.STAGE_PEAKS if b == peak),
                      "none")
        print(f"{tag} prove {total:.3f} s with the stage timers, peak "
              f"device memory {peak / 2**30:.2f} GiB, set in the stage "
              f"'{setter.strip()}', peak host RSS {rss / 2**20:.3f} GiB",
              flush=True)


if __name__ == "__main__":
    main()
