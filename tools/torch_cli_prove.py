"""Prove one cached block on the GPU through the port's CLI, as a user runs it.

    python3 tools/torch_cli_prove.py --input tests/fixtures/input_0x....json

Copies the input into a fresh cache directory and runs
``python -m zeth_tpu_torch.app.cli --cache-dir <dir> --block N prove``
in this process (the default ``--segment-po2 20``, every segment and
accelerator batch STARK-proved on the CUDA card, the receipt verified
against the image ID computed from the guest ELF and the journal against
the block hash). ``BlockProcessor.prove`` and ``Receipt.verify`` are
timed around the library's own calls (``chip_smoke.timed_cli``), so the
block is proved once. Prints the card's name and power limit, the CLI's
output, and one line with the prove and verify seconds, the segments and
their po2, the cycles, the batches, the leaf-kernel launches and the
peak device memory; then one JSON object with the same numbers. Exits
non-zero if the CLI does, or without a CUDA card.

Under ``ZETH_SUCCINCT=1`` the receipt is succinct: every (segment,
paging) pair and every accelerator batch is lifted and all are joined to
one root proof, which ``Receipt.verify`` checks. Each lift and join then
prints one line (``chip_smoke.recursion_proof``: program rows, recursion
po2, host and prove seconds, leaf launches, peak memory), and the JSON
object gains the recursion proofs' count and seconds, the bigint lift's
row and the root seal's words.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="torch_cli_prove")
    ap.add_argument("--input", default=None,
                    help="a cached input_0x<hash>.json (default: the "
                    "smaller committed fixture block)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_cli_prove: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.app.host import StatelessInput
    path = args.input or sorted(
        glob.glob(os.path.join(ROOT, "tests", "fixtures", "input_0x*.json")),
        key=os.path.getsize)[0]
    with open(path) as f:
        number = StatelessInput.from_json(json.load(f)).block.number
    card = cs.card_line()
    cs.log(f"[device] {card}")
    dev = torch.device("cuda", 0)
    torch.empty(1, device=dev)              # the context, for the counters
    rows, rec_rows = {}, []
    succinct = os.environ.get("ZETH_SUCCINCT", "0") == "1"
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(path, tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_counts()
        t0 = time.time()
        with cs.timed_cli(rows), (
                cs.timed_recursion(dev, card, rec_rows) if succinct
                else contextlib.nullcontext()):
            rc, out = cs.run_cli(["--cache-dir", tmp, "--block", str(number),
                                  "prove"])
        torch.cuda.synchronize()
        cli_s = time.time() - t0
    if rc != 0 or "receipt verified; journal matches block hash" not in out:
        cs.log(f"cli prove returned {rc}")
        return rc or 1
    receipt = rows["receipt"]
    st, inner = receipt.stats, receipt.inner
    po2s, batches = cs.receipt_po2s(inner)
    res = {"block": os.path.basename(path), "prove_s": rows["prove_s"],
           "verify_s": rows["verify_s"], "cli_s": cli_s,
           "segments": st.segments, "segment_po2s": po2s,
           "user_cycles": st.user_cycles, "paging_cycles": st.paging_cycles,
           "keccak_calls": st.keccak_calls, "batch_po2s": batches,
           "leaf_launches": kernels.LAUNCHES["poseidon2_leaf"],
           "peak_gib": max([torch.cuda.max_memory_allocated(dev) / 2**30]
                           + [r[k] for r in rec_rows
                              for k in ("peak_gib", "prior_peak_gib")]),
           "card": card}
    if succinct:
        big = [r for r in rec_rows if r.get("air") == "bigint2-modmul384"]
        res.update(
            recursion_proofs=len(rec_rows),
            recursion_s=sum(r["total_s"] for r in rec_rows),
            bigint_lift={k: v for r in big for k, v in r.items()
                         if k not in ("receipt", "air")},
            root_seal_words=int(inner.root_seal.shape[0]))
    cs.log(f"{card} | [cli-block] {res['block'][:24]}...: prove "
           f"{res['prove_s']:.3f} s, verify {res['verify_s']:.3f} s, cli all "
           f"{cli_s:.3f} s; {st.segments} segments at po2 {po2s}, "
           f"{st.user_cycles} user + {st.paging_cycles} paging cycles, "
           f"{st.keccak_calls} keccak calls, batches (po2) {batches}; "
           f"{res['leaf_launches']} leaf launches, peak device memory "
           f"{res['peak_gib']:.2f} GiB")
    if succinct:
        cs.log(f"{card} | [cli-block] succinct: {len(rec_rows)} recursion "
               f"proofs in {res['recursion_s']:.3f} s, root seal "
               f"{res['root_seal_words']} words")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
