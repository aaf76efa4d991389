"""The Poseidon2 leaf kernel against its parent, in turns on one GPU.

    git show <parent>:zeth_tpu_torch/kernels/csrc/poseidon2_leaf.cu \\
        > .chip_tree/parent_leaf.cu
    python3 tools/torch_leaf_turns.py --parent-source .chip_tree/parent_leaf.cu \\
        [--sweep] [--out chiprun_out/leaf_turns.json]

Builds the checkout's leaf kernel (``kernels.build_all``) and the
parent's source beside it as ``zeth_tpu_torch/build/libposeidon2_leaf_parent.so``
(the same ``nvcc`` flags, ``csrc/`` on the include path, so another
version of this source builds there too), prints what ``ptxas -v`` says
of both, and counts the SASS instructions of one permutation in each,
in all, by pipe and by opcode (``cuobjdump -sass``, the CUDA toolkit's;
``sass_per_permutation``). It times the integer instruction forms of
the kernels on their own (``tools/csrc/int_pipes.cu``, ``pipe_rates``):
the rate each pipe sustains. Then, at every ``chip_smoke.LEAF_SHAPES``
shape, on one random matrix: the two in turns (parent, change, change,
parent; CUDA events, the shape's kernel calls a turn, the SM clock read
after each turn), their digests held equal, and each of the change's
three mappings (1, 8 and 32 lanes a row, ``poseidon2_leaf_lanes``)
timed once and held equal to them too. Every launch goes through the
library's C entry point alone, into an output made beforehand, so that
parent and change pay the same host cost. With ``--sweep``, every
mapping also at each SWEEP_ROWS count of rows, at 1009 and at 84
columns: where the rule's switches lie.

Prints the card's name and power limit, one table row a shape (parent
and change as the means of their two turns, the change's share of the
bound of ``chip_smoke.leaf_bound_ms`` and of its own SASS at the pipes'
peak rates, ``sass_bound_ms``, the mapping the rule takes), and writes
the same as JSON to ``--out``. Exits non-zero without a CUDA card, if a
build fails, or if any two digests differ.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MAPPINGS = (1, 8, 32)
# the change's kernel of each mapping
MAPPING_KERNEL = {1: "row_kernel", 8: "seg_kernel", 32: "warp_kernel"}
# rows a warp of each kernel (the parent's leaf_kernel: one thread a row),
# to give the warp instructions a row's permutation costs
ROWS_A_WARP = {"row_kernel": 32, "seg_kernel": 4, "warp_kernel": 1,
               "leaf_kernel": 32}
# the trips of a rolled permutation's round loops, in the order of the
# code: 4 external, 21 internal, 4 external rounds
ROUND_TRIPS = (4, 21, 4)
SWEEP_COLS = (1009, 84)
# the sweep's rows, as (k, extra): k * SMs + extra rows. Around the
# rule's switches it is dense, and takes the first row past a whole
# number of blocks an SM (32 lanes: 4 rows a block, so 8 rows an SM are
# two blocks; 8 lanes: 16 rows a block, 96 rows an SM six)
SWEEP_ROWS = ((1, 0), (2, 0), (4, 0), (6, 0), (8, 0), (8, 1), (9, 0),
              (10, 0), (12, 0), (16, 0), (24, 0), (32, 0), (48, 0), (64, 0),
              (80, 0), (96, 0), (96, 1), (100, 0), (104, 0), (112, 0),
              (128, 0), (192, 0), (256, 0), (512, 0))
# tools/csrc/int_pipes.cu's instruction forms, by its op number
PIPE_SOURCE = os.path.join(ROOT, "tools", "csrc", "int_pipes.cu")
PIPE_FORMS = ("mad.lo.u32", "mad.hi.u32", "mad.wide.u32", "add.u32",
              "min(x, x - p)", "mul (poseidon2.cuh)", "add (poseidon2.cuh)")


def build(src: str, lib: str) -> str:
    """nvcc of `src` into the build directory as `lib`, with the kernels'
    flags and ``csrc/`` on the include path; returns the library's path."""
    from zeth_tpu_torch import kernels
    os.makedirs(kernels.BUILD, exist_ok=True)
    so = os.path.join(kernels.BUILD, lib)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
                           kernels.CSRC, "-o", so, os.path.abspath(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    print(f"[build] {src}: {(proc.stdout + proc.stderr).strip()}",
          flush=True)
    return so


# the pipe each SASS opcode issues to (chip_smoke.PEAK_PIPE each): the FMA
# pipe takes the integer multiplies, the ALU pipe integer additions,
# selects, min/max, compares, shifts and logic; anything else (loads,
# stores, shuffles, warp reductions, uniform-datapath and control
# instructions) counts as "other", which only issue slots bound
FMA_OPS = ("IMAD", "IMUL", "IDP", "HFMA2")
# the FMA-pipe opcodes that hold it two cycles: pipe_rates times
# mad.wide.u32 and mad.hi.u32 at half of mad.lo.u32's rate
FMA_TWO_CYCLES = ("IMAD.WIDE", "IMAD.HI")
ALU_OPS = ("IADD3", "VIADD", "VIADDMNMX", "VIMNMX", "IMNMX", "ISETP", "LOP3",
           "SHF", "LEA", "SEL", "PRMT", "MOV", "PLOP3", "P2R", "R2P")


def pipe_of(op: str) -> str:
    """"fma", "alu" or "other": the pipe of one SASS instruction's text."""
    name = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
    return ("fma" if name in FMA_OPS else
            "alu" if name in ALU_OPS else "other")


def sass_counts(text: str) -> dict:
    """{kernel: {"pass": SASS instructions one pass of its chunk loop
    executes (one permutation and its absorb), "fma" / "alu" / "other":
    the same by pipe (``pipe_of``), "fma_cycles": the cycles the FMA
    ones hold their pipe (FMA_TWO_CYCLES twice), "ops": by opcode,
    "code_bytes": the kernel's code}} for
    each kernel in `text`, the output of ``cuobjdump -sass``. The chunk
    loop is the kernel's widest backward branch. A full chunk skips the
    code an unconditional forward branch inside it jumps over (the ragged
    tail's absorb). A loop inside it is a rolled round loop: its body
    counts once a trip, the trips being ROUND_TRIPS in the order of the
    code; a kernel with other inner loops is not counted."""
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 text, re.S):
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        at = {a: i for i, (a, _) in enumerate(ins)}
        loops, jumps = [], []
        for i, (a, op) in enumerate(ins):
            m = re.match(r"(@!?U?P\w+ )?BRA (?:\S+, )?0x([0-9a-f]+)", op)
            if not m or int(m.group(2), 16) not in at:
                continue
            t = at[int(m.group(2), 16)]
            if t < i:
                loops.append((t, i))
            elif t > i + 1 and m.group(1) is None:
                jumps.append((i + 1, t))
        if not loops:
            continue
        start, end = max(loops, key=lambda lp: lp[1] - lp[0])
        skip = {j for a, b in jumps if start < a <= end for j in range(a, b)}
        inner = sorted(lp for lp in loops if lp != (start, end)
                       and start <= lp[0] and lp[1] < end)
        if inner and len(inner) != len(ROUND_TRIPS):
            continue
        times = {j: 1 for j in range(start, end + 1) if j not in skip}
        for (a, b), trips in zip(inner, ROUND_TRIPS):
            for j in range(a, b + 1):
                if j in times:
                    times[j] = trips
        counts = {"pass": sum(times.values()), "fma": 0, "fma_cycles": 0,
                  "alu": 0, "other": 0,
                  "code_bytes": ins[-1][0] - ins[0][0] + 16, "ops": {}}
        for j, n in times.items():
            pipe = pipe_of(ins[j][1])
            counts[pipe] += n
            op = re.sub(r"^@!?U?P\w+\s+", "", ins[j][1]).split()[0]
            counts["ops"][op] = counts["ops"].get(op, 0) + n
            if pipe == "fma":
                counts["fma_cycles"] += n * (
                    2 if op.startswith(FMA_TWO_CYCLES) else 1)
        short = re.search(r"\d+([a-z_]+_kernel)E", name)
        out[short.group(1) if short else name] = counts
    return out


def sass_bound_ms(counts: dict, rows: int, cols: int, lanes: int) -> float:
    """The least ms a kernel of these SASS ``counts`` (a lane's, one pass)
    can take for (rows, cols) on `lanes` lanes a row: every lane's passes
    at the rate of the busiest of the FMA pipe (its cycles, as pipe_rates
    measures them), the ALU pipe and issue."""
    import chip_smoke as cs
    lane_passes = rows * max(1, -(-cols // 16)) * lanes
    return lane_passes * max(counts["fma_cycles"] / cs.PEAK_PIPE,
                             counts["alu"] / cs.PEAK_PIPE,
                             counts["pass"] / cs.PEAK_ISSUE) * 1e3


def sass_per_permutation(so: str) -> dict:
    """``sass_counts`` of the library `so` (``cuobjdump``, beside nvcc)."""
    from zeth_tpu_torch import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    return sass_counts(subprocess.run([cuobjdump, "-sass", so],
                                      capture_output=True, text=True,
                                      check=True).stdout)


def pipe_rates(dev, card: str, sms: int) -> list:
    """Each PIPE_FORMS kernel of tools/csrc/int_pipes.cu timed (CUDA
    events) on sms * 32 blocks: the SASS instructions its loop issues a
    second, in all, on the FMA pipe (instructions and the cycles they
    hold it, FMA_TWO_CYCLES counted twice) and on the ALU pipe, and the
    same a cycle of one SM at the SM clock read after it (the pipes' peak:
    64 each, issue 128)."""
    import chip_smoke as cs
    so = build(PIPE_SOURCE, "libint_pipes.so")
    lib = ctypes.CDLL(so)
    lib.int_pipes.restype = ctypes.c_int
    lib.int_pipes.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    sass = sass_per_permutation(so)
    blocks, iters = sms * 32, 2048
    threads = blocks * lib.int_pipes_threads()
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = []
    for op, form in enumerate(PIPE_FORMS):
        counts = next(v for k, v in sass.items() if f"ILi{op}E" in k)

        def run():
            err = lib.int_pipes(op, out.data_ptr(), blocks, iters, 12345,
                                stream)
            if err:
                raise SystemExit(f"int_pipes {form}: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        _, ms = cs.cuda_ms(run, 5)
        mhz = cs.sm_mhz()
        steps = iters * threads / (ms * 1e-3)      # loop passes a second
        row = {"form": form, "ms": ms, "sm_mhz": mhz,
               "sass": {k: counts[k] for k in ("pass", "fma", "fma_cycles",
                                               "alu", "other", "ops")}}
        for pipe in ("pass", "fma", "fma_cycles", "alu"):
            row[f"{pipe}_per_s"] = counts[pipe] * steps
            row[f"{pipe}_per_sm_cycle"] = counts[pipe] * steps / (
                sms * mhz * 1e6)
        rates.append(row)
        print(f"{card} | [pipes] {form}: {ms:.4f} ms; a loop pass "
              f"{counts['pass']} SASS ({counts['fma']} FMA pipe, "
              f"{counts['alu']} ALU pipe; "
              + ", ".join(f"{k} {v}" for k, v in sorted(
                  counts["ops"].items(), key=lambda x: -x[1])[:4])
              + f"); a cycle an SM at {mhz} MHz: "
              f"{row['pass_per_sm_cycle']:.1f} issued, "
              f"{row['fma_per_sm_cycle']:.1f} FMA pipe "
              f"({row['fma_cycles_per_sm_cycle']:.1f} of its cycles), "
              f"{row['alu_per_sm_cycle']:.1f} ALU pipe", flush=True)
    return rates


def launch(lib, rows, out, lanes=None):
    """One launch of a leaf library's kernel on `rows` into `out`, through
    its C entry point alone (``poseidon2_leaf``, or ``poseidon2_leaf_lanes``
    with `lanes`), so that parent and change pay the same host cost; a
    one-row launch takes tens of microseconds."""
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    args = (rows.data_ptr(), out.data_ptr(), rows.shape[0], rows.shape[1])
    err = (lib.poseidon2_leaf(*args, stream) if lanes is None
           else lib.poseidon2_leaf_lanes(*args, lanes, stream))
    if err:
        raise SystemExit(f"poseidon2_leaf launch failed: CUDA error {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_leaf_turns")
    ap.add_argument("--parent-source", required=True,
                    help="the parent commit's poseidon2_leaf.cu, or any "
                         "other version of it to hold the change against")
    ap.add_argument("--label", default="parent",
                    help="what --parent-source is, in the output")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every mapping at rows = k * SMs")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "leaf_turns.json"))
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("torch_leaf_turns: no CUDA device")
    import chip_smoke as cs
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.hash import poseidon2 as P2
    from zeth_tpu_torch.hostmath import P

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[device] {card}; {sms} SMs; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    for name, log in kernels.build_all(["poseidon2_leaf"], force=True).items():
        print(f"[build] {name}: {log.strip()}", flush=True)
    parent_so = build(args.parent_source, "libposeidon2_leaf_parent.so")
    parent = P2._kernel_lib("poseidon2_leaf", ctypes.CDLL(parent_so))
    change = P2._leaf_lib()
    sass = {args.label: sass_per_permutation(parent_so),
            "change": sass_per_permutation(
                os.path.join(kernels.BUILD, "libposeidon2_leaf.so"))}
    for which, counts in sass.items():
        print(f"[sass] {which}: SASS instructions of a chunk loop pass "
              "(a permutation and its absorb), a lane: " + "; ".join(
                  f"{k} {v['pass']} ({v['pass'] / ROWS_A_WARP.get(k, 1):.1f} "
                  f"warp instructions a row; FMA pipe {v['fma']} holding it "
                  f"{v['fma_cycles']} cycles, ALU pipe {v['alu']}, other "
                  f"{v['other']}; code {v['code_bytes']} bytes)"
                  for k, v in counts.items()),
              flush=True)
    pipes = pipe_rates(dev, card, sms)

    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows_out = []
    for rows_n, cols, reps, _ in cs.LEAF_SHAPES:
        x = torch.randint(0, P, (rows_n, cols), dtype=torch.int32,
                          device=dev, generator=gen)
        outs = {k: torch.empty((rows_n, 8), dtype=torch.int32, device=dev)
                for k in ("parent", "change")}
        launch(parent, x, outs["parent"])
        launch(change, x, outs["change"])
        torch.cuda.synchronize()
        t = cs.turns(card, f"({rows_n}, {cols}) {args.label} /",
                     {"parent": lambda: launch(parent, x, outs["parent"]),
                      "change": lambda: launch(change, x, outs["change"])},
                     {"parent": reps, "change": reps})
        want = t["parent"][0]
        if not torch.equal(t["change"][0], want):
            raise SystemExit(f"the change disagrees with the parent at "
                             f"{(rows_n, cols)}")
        lanes_ms = {}
        for lanes in MAPPINGS:
            out = torch.empty_like(want)
            launch(change, x, out, lanes)
            got, lanes_ms[lanes] = cs.cuda_ms(
                lambda: launch(change, x, out, lanes), reps)
            if not torch.equal(got, want):
                raise SystemExit(f"{lanes} lanes a row disagree with the "
                                 f"parent at {(rows_n, cols)}")
        parent_ms = sum(t["parent"][1]) / 2
        ms = sum(t["change"][1]) / 2
        bound, by = cs.leaf_bound_ms(rows_n, cols)
        lanes = P2._leaf_mapping(rows_n, dev)
        sass_ms = sass_bound_ms(sass["change"][MAPPING_KERNEL[lanes]],
                                rows_n, cols, lanes)
        rows_out.append({
            "rows": rows_n, "cols": cols, "parent_ms": t["parent"][1],
            "ms": t["change"][1], "sm_mhz": t["mhz"], "lanes": lanes,
            "lanes_ms": lanes_ms, "bound_ms": bound, "bound_by": by,
            "sass_bound_ms": sass_ms})
        print(f"{card} | [turns] ({rows_n}, {cols}): {args.label} "
              f"{parent_ms:.3f} ms, change {ms:.3f} ms "
              f"({ms / parent_ms:.3f} of it; {lanes} lanes a row), bound "
              f"{bound:.6f} ms by {by} ({bound / ms:.1%} of the change), "
              f"its SASS at the pipes' peak {sass_ms:.6f} ms "
              f"({sass_ms / ms:.1%}), mappings " + ", ".join(
                  f"{k}: {v:.3f} ms" for k, v in lanes_ms.items())
              + "; equal", flush=True)
        del x, t, want, got, out, outs
        torch.cuda.empty_cache()

    sweep = []
    if args.sweep:
        for cols in SWEEP_COLS:
            for k, extra in SWEEP_ROWS:
                rows_n = k * sms + extra
                x = torch.randint(0, P, (rows_n, cols), dtype=torch.int32,
                                  device=dev, generator=gen)
                ms, want = {}, None
                for lanes in MAPPINGS:
                    out = torch.empty((rows_n, 8), dtype=torch.int32,
                                      device=dev)
                    launch(change, x, out, lanes)
                    got, ms[lanes] = cs.cuda_ms(
                        lambda: launch(change, x, out, lanes), 5)
                    if want is not None and not torch.equal(got, want):
                        raise SystemExit(f"the mappings disagree at "
                                         f"{(rows_n, cols)}")
                    want = got
                rule = P2._leaf_mapping(rows_n, dev)
                sweep.append({"rows": rows_n, "cols": cols, "lanes": rule,
                              "lanes_ms": ms})
                print(f"{card} | [sweep] ({rows_n} = {k} x {sms} SMs"
                      + (f" + {extra}" if extra else "") + f", {cols}): "
                      + ", ".join(
                          f"{a} lanes {b:.4f} ms" for a, b in ms.items())
                      + f"; the rule takes {rule}", flush=True)
                del x, want, got, out

    print(f"| (rows, cols) | {args.label} ms (2 turns) | change ms (2 turns) "
          f"| change / {args.label} | bound ms | bound / change | SASS at "
          "peak ms | that / change | rule | 1 / 8 / 32 lanes ms |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows_out:
        pm, m = sum(r["parent_ms"]) / 2, sum(r["ms"]) / 2
        print(f"| ({r['rows']}, {r['cols']}) | "
              f"{r['parent_ms'][0]:.3f} / {r['parent_ms'][1]:.3f} | "
              f"{r['ms'][0]:.3f} / {r['ms'][1]:.3f} | {m / pm:.3f} | "
              f"{r['bound_ms']:.6f} | {r['bound_ms'] / m:.1%} | "
              f"{r['sass_bound_ms']:.6f} | {r['sass_bound_ms'] / m:.1%} | "
              f"{r['lanes']} | " + " / ".join(
                  f"{v:.3f}" for v in r["lanes_ms"].values()) + " |")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "sms": sms, "label": args.label,
                   "parent_source": args.parent_source, "sass": sass,
                   "pipes": pipes, "shapes": rows_out, "sweep": sweep}, f,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
