"""Multi-block proving pipeline: the run-parallel.sh equivalent.

Replaces the reference's benchmark driver (SURVEY.md §2.1 + §3.5,
run-parallel.sh): fan out over every cached block input, dev-mode prove
each, and emit the same CSV schema:

  block_number,execution_time,total_cycles,user_cycles,paging_cycles,
  keccak_calls,gas_used

(run-parallel.sh:15). Cycle counts come from the native validation path's
executor accounting when an EVM guest is available; until then (v1) the
validation work itself is timed and cycle columns report the dev-mode
executor's numbers when a guest ELF is configured, else zeros.

Process-level parallelism mirrors `parallel --jobs N` (run-parallel.sh:93)
with a process pool; this is the reference's "block parallelism" axis
(SURVEY.md §2.3), which the pod-level scheduler in zeth_tpu_torch.recursion
supersedes for real proving.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor


def process_file(path: str) -> dict:
    os.environ.setdefault("ZETH_DEV_MODE", "1")
    from .host import BlockProcessor, StatelessInput

    with open(path) as f:
        data = json.load(f)
    inp = StatelessInput.from_json(data)
    proc = BlockProcessor.for_chain_id(int(os.environ.get("ZETH_CHAIN_ID", "1")))
    t0 = time.time()
    receipt = proc.prove(inp)
    dt_ms = (time.time() - t0) * 1e3
    # verify against the independently derived image ID (cli.rs:100-108)
    receipt.verify(proc.image_id())
    gas_used = inp.block.fields.get("gas_used", 0)
    # cycle columns come straight from the stateless-client guest's zkVM
    # execution (prove runs it even in dev mode) — the reference's
    # scrape categories, run-parallel.sh:67-70
    st = receipt.stats
    cycles = {"total_cycles": st.total_cycles,
              "user_cycles": st.user_cycles,
              "paging_cycles": st.paging_cycles,
              "keccak_calls": st.keccak_calls}
    return {
        "block_number": inp.block.number,
        "execution_time": f"{dt_ms:.0f}ms",
        **cycles,
        "gas_used": gas_used,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zeth-tpu-run-parallel")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--cache-dir", default="cache")
    ap.add_argument("--output", default="results.csv")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.cache_dir, "input_0x*.json")))
    if not files:
        print(f"no cached inputs in {args.cache_dir}", file=sys.stderr)
        return 1

    fields = ["block_number", "execution_time", "total_cycles",
              "user_cycles", "paging_cycles", "keccak_calls", "gas_used"]
    rows = []
    with ProcessPoolExecutor(max_workers=args.jobs) as pool:
        for row in pool.map(process_file, files):
            rows.append(row)
            print(",".join(str(row[f]) for f in fields))
    with open(args.output, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {args.output} ({len(rows)} blocks)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
