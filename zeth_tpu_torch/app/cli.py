"""End-user CLI: validate / prove cached or fetched blocks.

Replaces the reference CLI (SURVEY.md §2.1, crates/host/src/bin/cli.rs):
`cli [--eth-rpc-url URL] [--block N] [--cache-dir DIR] {validate|prove
[--segment-po2 N]}` with the same JSON input cache keyed by block hash,
always-host-validate behavior, and the journal == block-hash check
(cli.rs:96-108). Dev mode via ZETH_DEV_MODE=1 (reference RISC0_DEV_MODE).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from .chainspec import BY_CHAIN_ID
from .host import BlockProcessor, StatelessInput


def _find_cached(cache_dir: str, block: int | None) -> str | None:
    for path in sorted(glob.glob(os.path.join(cache_dir, "input_0x*.json"))):
        if block is None:
            return path
        try:
            with open(path) as f:
                data = json.load(f)
            inp = StatelessInput.from_json(data)
            if inp.block.number == block:
                return path
        except Exception:
            continue
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zeth-tpu")
    ap.add_argument("--eth-rpc-url", default=os.environ.get("ETH_RPC_URL"))
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--cache-dir", default="cache")
    ap.add_argument("--chain-id", type=int, default=1)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("validate")
    p_prove = sub.add_parser("prove")
    p_prove.add_argument("--segment-po2", type=int,
                         default=int(os.environ.get("SEGMENT_PO2", "20")))
    args = ap.parse_args(argv)

    proc = BlockProcessor.for_chain_id(args.chain_id, args.eth_rpc_url)

    # cache-or-fetch (cli.rs:113-145)
    path = _find_cached(args.cache_dir, args.block)
    if path is not None:
        print(f"loading cached input: {path}")
        inp = proc.load_cached_input(path)
    else:
        if not args.eth_rpc_url:
            print("no cached input and no --eth-rpc-url", file=sys.stderr)
            return 1
        inp = proc.create_input(args.block if args.block is not None
                                else "latest")
        proc.save_input(args.cache_dir, inp.raw)

    size_mb = len(json.dumps(inp.raw)) / 1e6 if inp.raw else 0.0
    print(f"input size: {size_mb:.2f} MB")

    t0 = time.time()
    block_hash = proc.validate(inp)
    print(f"block {inp.block.number} validated in "
          f"{(time.time() - t0) * 1e3:.0f}ms; hash 0x{block_hash.hex()}")

    if args.cmd == "prove":
        t0 = time.time()
        receipt = proc.prove(inp, segment_po2=args.segment_po2)
        print(f"execution time: {(time.time() - t0) * 1e3:.0f}ms")
        # verify against the independently computed image ID, never the
        # receipt's own claim (cli.rs:100-108)
        receipt.verify(proc.image_id())
        if receipt.journal != block_hash:
            print("journal does not match block hash!", file=sys.stderr)
            return 1
        print("receipt verified; journal matches block hash")
    return 0


if __name__ == "__main__":
    sys.exit(main())
