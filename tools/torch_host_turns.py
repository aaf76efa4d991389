"""Time two checkouts of zeth_tpu_torch against each other in turns on one card.

    python3 tools/torch_host_turns.py --parent DIR [--paths evm,spin,bigint]
                                      [--repeat 2] [--lift]

For each path, runs ``tools/torch_stages.py --path P --repeat N`` four
times, each in a process of its own, in the order parent, change, change,
parent: ``--tree DIR`` for the parent, this checkout for the change. A
drift of the host over the call then falls on both sides alike. Each
process's output goes to ``chiprun_out/host_turns/``. This script sums
each stage's seconds within a prove and prints, for each path, prove (1
to N within a process) and stage, the two processes' seconds on each
side, their means and change / parent; the same for the prove's total
and for the peak host RSS (``ru_maxrss``) at the end of the prove.

``--lift`` then lifts the fixture block's bigint batch at recursion
po2=24 once on each side (``tools/torch_lift_batch.py`` of each
checkout, parent first) and prints the lift's compile, interpreter,
control-trace, ``build_aux`` and prove seconds and the process's peak
host RSS. The table goes to ``chiprun_out/host_turns/summary.json`` too.

The script sets nothing in the processes it starts: each one's allocator
settings are those its own ``zeth_tpu_torch`` import makes. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "host_turns")
ORDER = ("parent", "change", "change", "parent")
STAGE = re.compile(r"\[(\w+)-stages \S+ run (\d+)\] (.+): ([0-9.]+) s$")
TOTAL = re.compile(r"\[(\w+)-stages \S+ run (\d+)\] prove ([0-9.]+) s with "
                   r".*peak host RSS ([0-9.]+) GiB")
# runs a checkout's lift tool as its own __main__, then prints the
# process's peak resident set (Linux gives KiB)
LIFT = """
import resource, runpy, sys
sys.argv = [sys.argv[1]]
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
finally:
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"[host-turns] peak host RSS {rss / 2**20:.3f} GiB", flush=True)
"""


def run(cmd: list, log: str, cwd: str) -> str:
    """Run `cmd`, keep its output in `log`; fail the script on an error."""
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    with open(log, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    print(f"[host-turns] {os.path.basename(log)}: exit {proc.returncode} "
          f"in {time.time() - t0:.1f} s", flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"{' '.join(cmd)} failed; see {log}")
    return proc.stdout


def parse_stages(out: str) -> dict:
    """prove index -> {stage: seconds summed, "prove total": s, "peak host
    RSS (GiB)": g} from one torch_stages process's output."""
    runs: dict = {}
    for line in out.splitlines():
        m = TOTAL.search(line)
        if m:
            r = runs.setdefault(int(m[2]), {})
            r["prove total"] = float(m[3])
            r["peak host RSS (GiB)"] = float(m[4])
            continue
        m = STAGE.search(line)
        if m:
            r = runs.setdefault(int(m[2]), {})
            r[m[3]] = r.get(m[3], 0.0) + float(m[4])
    return runs


def table(samples: dict) -> list:
    """samples: side -> [value, value] -> one row of means and ratio."""
    p, c = samples["parent"], samples["change"]
    mp, mc = sum(p) / len(p), sum(c) / len(c)
    return [p, c, mp, mc, mc / mp if mp else None]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="checkout of the parent commit")
    ap.add_argument("--paths", default="evm,spin,bigint")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--lift", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_host_turns: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    parent = os.path.abspath(args.parent)
    trees = {"parent": parent, "change": ROOT}
    os.makedirs(OUT, exist_ok=True)
    card = CS.card_line()
    print(f"[host-turns] {card}; parent {parent}, change {ROOT}", flush=True)
    summary = {"card": card, "paths": {}, "lift": {}}
    stages_py = os.path.join(ROOT, "tools", "torch_stages.py")
    for path in args.paths.split(","):
        got = {}
        for i, side in enumerate(ORDER):
            out = run([sys.executable, stages_py, "--path", path,
                       "--repeat", str(args.repeat), "--tree", trees[side]],
                      os.path.join(OUT, f"{path}-{i}-{side}.log"), ROOT)
            for k, stages in parse_stages(out).items():
                for name, v in stages.items():
                    got.setdefault((k, name), {"parent": [], "change": []})
                    got[(k, name)][side].append(v)
        rows = summary["paths"][path] = {}
        for (k, name), samples in sorted(got.items()):
            row = table(samples)
            rows[f"prove {k}: {name}"] = row
            ratio = "n/a" if row[4] is None else f"{row[4]:.3f}"
            print(f"{card} | [host-turns {path}] prove {k}: {name}: parent "
                  f"{row[0]}, change {row[1]}; mean {row[2]:.3f} -> "
                  f"{row[3]:.3f}, change/parent {ratio}", flush=True)
    if args.lift:
        for side in ("parent", "change"):
            tool = os.path.join(trees[side], "tools", "torch_lift_batch.py")
            out = run([sys.executable, "-c", LIFT, tool],
                      os.path.join(OUT, f"lift-{side}.log"), trees[side])
            row = json.loads(next(line for line in reversed(out.splitlines())
                                  if line.startswith("{")))
            row["rss_gib"] = float(re.search(
                r"peak host RSS ([0-9.]+) GiB", out)[1])
            row.pop("leaf_kernel", None)
            summary["lift"][side] = row
            print(f"{card} | [host-turns lift] {side}: compile "
                  f"{row['compile_s']:.3f} s, interpreter "
                  f"{row['witgen_s']:.3f} s, control trace "
                  f"{row['control_s']:.3f} s, build_aux {row['aux_s']:.3f} "
                  f"s, prove {row['prove_s']:.3f} s, lift {row['lift_s']:.3f}"
                  f" s, batch prove {row['batch_prove_s']:.3f} s, peak host "
                  f"RSS {row['rss_gib']:.3f} GiB", flush=True)
    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(card)


if __name__ == "__main__":
    main()
