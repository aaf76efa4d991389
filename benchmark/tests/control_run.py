"""The control on the card at a cell's own size: whole runs of the cell
with the program's lower-security path switched on (FRI with one query
fewer than the 50 the configuration's proofs state), one per seed, in
one process. Each run prints its numbers beside their limits; every run
must come out not correct.

    python3 benchmark/tests/control_run.py --workload keccak.batch \\
        --seconds 10 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    import torch
    from harness import cell as cell_mod
    from harness import spec
    from zeth_tpu_torch.zkp import fri
    if not torch.cuda.is_available():
        print("control_run: needs a CUDA card", file=sys.stderr)
        return 2
    c = spec.load(args.workload)
    fri.QUERIES -= 1
    all_failed = True
    for seed in args.seeds:
        out = cell_mod.run(c, seed, args.seconds, False,
                           torch.device("cuda", 0), time.perf_counter())
        correct, check = cell_mod.verdict(out["counts"])
        all_failed &= not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": f"FRI queries {fri.QUERIES}",
                          "correct": correct, "attempted": out["attempted"],
                          "check": check}), flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
