"""EVM segments: ``zeth_tpu_torch.circuits.rv32im.prove_segment``.

Set-up builds the stateless-client guest ELF (cached inside the
checkout, ``zeth_tpu_torch/guest/.build``), executes each fixture block
of the mix at the configuration's segment po2 and keeps its first
segment: ``prove_segments`` starts from the pristine image, so only a
first segment stands alone. Each unit of the window proves one of them,
with its paging proof inline. The work a unit does is the segment's
executed guest cycles (the executor's user cycles, which the reference
counts again), in millions.
"""

from __future__ import annotations

import json
import os


def metrics(work: float, units: int, seconds: float) -> dict:
    """The window's executed guest cycles proved a second, in millions."""
    return {"segment_mcycles_per_s": work / seconds}


class Workload:
    def __init__(self, config: dict, device):
        from zeth_tpu_torch.app import guest_input
        from zeth_tpu_torch.executor import load_image
        self.device = device
        self.po2 = int(config["segment_po2"])
        self.elf = guest_input.build_stateless_elf()
        _, self.addrs, self.words = load_image(self.elf)
        self.segments = {}

    def _segment(self, path: str):
        """The first segment of the block in `path`, the guest's input
        bytes and the block hash (the fixture's name carries it)."""
        if path not in self.segments:
            from zeth_tpu_torch.app import guest_input
            from zeth_tpu_torch.app.chainspec import MAINNET
            from zeth_tpu_torch.app.host import StatelessInput
            from zeth_tpu_torch.executor import Executor
            with open(path) as f:
                inp = StatelessInput.from_json(json.load(f))
            raw = guest_input.encode_guest_input(inp, MAINNET.chain_id)
            seg = Executor(self.elf, input_bytes=raw, segment_po2=self.po2,
                           trace=True).run().segments[0]
            block_hash = bytes.fromhex(
                os.path.basename(path).split("_0x")[1].split(".")[0])
            self.segments[path] = (seg, raw, block_hash)
        return self.segments[path]

    def setup(self, warm: list) -> None:
        """Execute every block of the mix and prove each first segment
        once, at the shapes the window will prove."""
        for path in warm:
            self._segment(path)
        for path in warm:
            self.prove(path)

    def prove(self, path: str):
        from zeth_tpu_torch.circuits import rv32im
        seg = self._segment(path)[0]
        return rv32im.prove_segment(seg, self.addrs, self.words,
                                    device=self.device)

    def work(self, path: str) -> float:
        return self._segment(path)[0].user_cycles / 1e6

    def answers(self, done: list) -> dict:
        """What the reference judges, on the host: every proof of the
        window with its block's input bytes, block hash and the cycles
        the program counted, the ELF and the segment po2."""
        proofs = []
        for path, out, _, _ in done:
            if out is not None:
                seg, raw, block_hash = self._segment(path)
                proofs.append((out[0], out[1], raw, block_hash,
                               seg.user_cycles))
        return {"elf": self.elf, "po2": self.po2, "proofs": proofs}


def check(answers: dict, seed: int, device) -> dict:
    """The counts ``correct`` holds to zero, over every segment proved in
    the window; the reference executes each block's first segment once."""
    from reference import check as ref
    image = ref.image_of(answers["elf"])
    runs = {}
    rejected = wrong = 0
    for seal, pg_seal, raw, block_hash, cycles in answers["proofs"]:
        if raw not in runs:
            runs[raw] = ref.execute(image, raw, answers["po2"])
        r, w = ref.check_segment(seal, pg_seal, image, runs[raw],
                                 block_hash, cycles, device)
        rejected += r
        wrong += len(w)
        if w:
            print(f"[reference] claim values that differ: {', '.join(w)}")
    return {"seals_rejected": rejected, "claims_wrong": wrong}
