"""Keccak accelerator batches: ``zeth_tpu_torch.circuits.keccak.prove_batch``.

Each unit proves one batch of keccak-f[1600] input states from the mix;
its work is the batch's permutations. Set-up proves one batch of the
same shape.
"""

from __future__ import annotations

import numpy as np


def metrics(work: float, units: int, seconds: float) -> dict:
    """The window's keccak-f permutations proved a second."""
    return {"keccak_perms_per_s": work / seconds}


class Workload:
    def __init__(self, config: dict, device):
        self.device = device

    def setup(self, warm: list) -> None:
        for states in warm:
            self.prove(states)

    def prove(self, states: np.ndarray):
        from zeth_tpu_torch.circuits import keccak
        return keccak.prove_batch(states, device=self.device)

    def work(self, states: np.ndarray) -> float:
        return float(states.shape[0])

    def answers(self, done: list) -> dict:
        """Every batch of the window: its states, seal and digest (None
        where the prove failed)."""
        return {"batches": [(states, None if out is None else out[0],
                             None if out is None else out[1])
                            for states, out, _, _ in done]}


def check(answers: dict, seed: int, device) -> dict:
    """The counts ``correct`` holds to zero, over every batch proved in
    the window."""
    from reference import check as ref
    rejected = wrong = 0
    words, digests = [], []
    for states, seal, digest in answers["batches"]:
        if seal is None:
            continue
        r, w, io = ref.check_keccak_batch(seal, states, device)
        rejected += r
        wrong += len(w)
        if w:
            print(f"[reference] claim values that differ: {', '.join(w)}")
        words.append(io)
        digests.append(digest)
    if words:
        for want, got in zip(ref.claims_digests(words), digests):
            if not (np.asarray(got, np.uint64) == want).all():
                wrong += 1
                print("[reference] claim values that differ: digest")
    return {"seals_rejected": rejected, "claims_wrong": wrong}
