"""Lift the fixture block's bigint batch into the recursion circuit on the GPU.

    python3 tools/torch_lift_batch.py [--input FILE]

Executes the stateless-client guest on one cached block (default: the
smaller committed fixture block), builds its bigint batch as
``zkvm.LocalProver`` does (every bigint call of the execution), proves it
with ``bigint2.prove_batch`` and lifts that proof with ``succinct.lift``
on the CUDA card, then verifies the lift proof with the port's verifier
(``succinct.verify_root`` over the one lift). The block's 25,825 modmuls
make a recursion program of ~10.3 M rows, a po2=24 proof whose main LDE
the prover coset-streams (``prover.STREAM_MAIN_BYTES``).

Prints the card's name and power limit; the batch's prove seconds; the
lift's program rows and recursion po2, its compile, interpreter,
control-trace, ``build_aux`` and prove seconds (the prover's
``STAGE_LOG``), its leaf-kernel launches and peak device memory; the
lift's peak device memory so far at the end of each prover stage
(``STAGE_PEAKS``: the first stage that reaches the peak set it); the
verify seconds; the leaf kernel against ``hash_rows`` with its time and
bound at the lift's two leaf shapes (chip_smoke's shape loop); then one
JSON object with the same numbers. Exits non-zero without a CUDA card
or if the lift does not verify.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_lift_batch")
    ap.add_argument("--input", default=None,
                    help="a cached input_0x<hash>.json (default: the "
                    "smaller committed fixture block)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_lift_batch: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zeth_tpu_torch import kernels, zkvm
    from zeth_tpu_torch.app import guest_input
    from zeth_tpu_torch.app.chainspec import MAINNET
    from zeth_tpu_torch.app.host import StatelessInput
    from zeth_tpu_torch.circuits import bigint2
    from zeth_tpu_torch.executor import Executor
    from zeth_tpu_torch.hostmath import P
    from zeth_tpu_torch.recursion import succinct
    from zeth_tpu_torch.zkp import proof as proof_mod
    from zeth_tpu_torch.zkp import prover

    path = args.input or sorted(
        glob.glob(os.path.join(ROOT, "tests", "fixtures", "input_0x*.json")),
        key=os.path.getsize)[0]
    card = cs.card_line()
    cs.log(f"[device] {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)
    t0 = time.time()
    logs = kernels.build_all(force=True)
    cs.log(f"[build] {len(logs)} kernel(s) in {time.time() - t0:.1f} s")

    with open(path) as f:
        inp = StatelessInput.from_json(json.load(f))
    t0 = time.time()
    elf = guest_input.build_stateless_elf()
    raw = guest_input.encode_guest_input(inp, MAINNET.chain_id)
    ex = Executor(elf, input_bytes=raw, segment_po2=20)
    res = ex.run()
    if res.exit_code != 0 or res.journal != inp.block.hash():
        cs.log("the guest did not validate the block")
        return 1
    ops = zkvm.accelerator_batches(ex)["bigint"][0]
    cs.log(f"[lift] {os.path.basename(path)[:24]}...: guest compiled and "
           f"executed in {time.time() - t0:.1f} s, {len(ops)} bigint calls")

    torch.cuda.synchronize()
    t0 = time.time()
    seal, _ = bigint2.prove_batch(ops, device=dev)
    torch.cuda.synchronize()
    batch_s = time.time() - t0
    inner = proof_mod.decode(seal)
    cs.log(f"{card} | [lift] bigint prove_batch {batch_s:.3f} s, "
           f"po2={inner.po2}, {len(inner.publics)} publics")

    air = bigint2.Bigint2Air()
    keep_timing = prover.TIMING
    prover.TIMING = True
    prover.STAGE_LOG.clear()
    prover.STAGE_PEAKS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    try:
        t0 = time.time()
        rec = succinct.lift(air, inner, device=dev)
        torch.cuda.synchronize()
        lift_s = time.time() - t0
    finally:
        prover.TIMING = keep_timing
    launches = kernels.LAUNCHES["poseidon2_leaf"]
    sums = {}
    for name, dt in prover.STAGE_LOG:
        sums[name.strip()] = sums.get(name.strip(), 0.0) + dt
    pr = rec.node.program
    row = {"block": os.path.basename(path), "bigint_calls": len(ops),
           "batch_po2": inner.po2, "batch_prove_s": batch_s,
           "rows": pr.n_rows, "po2": pr.po2(),
           "compile_s": sums.get("recursion compile (host)", 0.0),
           "witgen_s": sums["recursion witgen (host, native)"],
           "control_s": sums["control trace (host)"],
           "aux_s": sums["aux witgen (host)"],
           "prove_s": sums["recursion prove"], "lift_s": lift_s,
           "main_streamed": prover.BLOWUP * (1 << pr.po2()) * 4
           * rec.node.air().main_cols > prover.STREAM_MAIN_BYTES,
           "leaf_launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
           "card": card}
    cs.log(f"{card} | [lift] bigint batch: {row['rows']} program rows, "
           f"recursion po2={row['po2']} (main group "
           f"{'streamed' if row['main_streamed'] else 'resident'}); "
           f"compile {row['compile_s']:.3f} s, interpreter "
           f"{row['witgen_s']:.3f} s, control trace {row['control_s']:.3f} s, build_aux {row['aux_s']:.3f} s, "
           f"prove {row['prove_s']:.3f} s (the last three inside it), all "
           f"{lift_s:.3f} s; {launches} leaf launches, peak device memory "
           f"{row['peak_gib']:.2f} GiB (reserved at most "
           f"{row['reserved_gib']:.2f} GiB)")
    for name, dt in prover.STAGE_LOG:
        cs.log(f"{card} | [lift-stage] {name.strip()}: {dt:.3f} s")
    for name, peak in prover.STAGE_PEAKS:
        cs.log(f"{card} | [lift-peak] {name.strip()}: peak so far "
               f"{peak / 2**30:.2f} GiB")

    t0 = time.time()
    succinct.verify_root(rec, air, [inner.po2],
                         [[int(p) for p in inner.publics]], device=dev)
    row["verify_s"] = time.time() - t0
    cs.log(f"{card} | [lift] the lift proof verified in "
           f"{row['verify_s']:.3f} s (its program compiled already), seal "
           f"{proof_mod.encode(rec.proof).shape[0]} words")
    del rec
    torch.cuda.empty_cache()
    # the leaf kernel at the lift's shapes: one coset of the streamed
    # main group (4 launches per main commit) and the control LDE, whose
    # whole plain hash_rows would hold some 60 GB: it checks 2^20 rows
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    row["leaf_kernel"] = []
    for shape, plain_rows in (((1 << 24, 84, 3, 1), None),
                              ((1 << 26, 70, 3, 1), 1 << 20)):
        row["leaf_kernel"] += cs.leaf_shapes(dev, card, P, gen, [shape],
                                             plain_rows)[1]
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
