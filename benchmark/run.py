"""Run one cell of the benchmark of ``zeth_tpu_torch`` on this machine.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number that decides ``correct``
with its limit, which are also the last lines of standard error. Exits
with another code, and prints no result, without the CUDA cards the cell
asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

# top-level module names a run must not have loaded; the port's own name
# begins with the JAX package's, so names are compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "zeth_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from harness import cell as cell_mod
    from harness import spec
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), STARTED)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    correct, check = cell_mod.verdict(out["counts"])
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": out["device"]}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["check"] = check
    print(f"[benchmark] reference {out['reference_s']:.1f} s",
          file=sys.stderr)
    for k, c in check.items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
