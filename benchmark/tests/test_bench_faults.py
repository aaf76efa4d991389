"""Whole runs of each cell at a test size on the CPU, past the look for a
chip: ``correct`` holds on the sound program, and comes out false with
the control (the program's own lower-security path: FRI with 49 queries
where the configuration's proofs state 50) and with each fault the cell
can have, planted underneath the timed path."""

import os

import numpy as np
import pytest

from harness import cell as cell_mod
from harness import spec

SEED = 2**33 + 5


@pytest.fixture
def keccak_cell(tmp_path):
    """The keccak cell with its mix cut to the recorded file's first four
    states."""
    c = spec.load("keccak.batch")
    with open(os.path.join(c.dir, c.traffic["file"])) as f:
        head = [next(f) for _ in range(4)]
    small = tmp_path / "keccak_inputs.csv"
    small.write_text("".join(head))
    c.traffic = dict(c.traffic, file=str(small))
    return c


def _evm_cell():
    c = spec.load("evm.segments")
    c.traffic = dict(c.traffic, files=c.traffic["files"][:1])
    c.config = dict(c.config, segment_po2=14)
    return c


def _run(c, device="cpu"):
    out = cell_mod.run(c, SEED, 0, False, device, 0.0)
    return cell_mod.verdict(out["counts"])


def _flip(seal):
    bad = np.array(seal, copy=True)
    bad[len(bad) // 2] ^= 1
    return bad


def _keccak_faults():
    from zeth_tpu_torch.circuits import keccak
    from zeth_tpu_torch.hash import poseidon2
    prove, leaf = keccak.prove_batch, poseidon2.leaf_hash

    def seal_altered(states, device=None):
        seal, digest = prove(states, device=device)
        return _flip(seal), digest

    def half_left_out(states, device=None):
        return prove(states[:len(states) // 2], device=device)

    def digest_altered(states, device=None):
        seal, digest = prove(states, device=device)
        return seal, digest ^ np.uint64(1)

    def leaf_altered(rows):
        out = leaf(rows).clone()
        out[-1, 0] ^= 1
        return out
    return {
        "seal altered": (keccak, "prove_batch", seal_altered),
        "half the batch left out": (keccak, "prove_batch", half_left_out),
        "digest altered": (keccak, "prove_batch", digest_altered),
        "leaf digest altered": (poseidon2, "leaf_hash", leaf_altered),
    }


def test_keccak_sound_run_is_correct(keccak_cell):
    correct, checked = _run(keccak_cell)
    assert correct, checked


def test_keccak_control_fails(monkeypatch, keccak_cell):
    from zeth_tpu_torch.zkp import fri
    monkeypatch.setattr(fri, "QUERIES", fri.QUERIES - 1)
    correct, checked = _run(keccak_cell)
    assert not correct and checked["seals_rejected"]["value"] >= 1


@pytest.mark.parametrize("fault", sorted(_keccak_faults()))
def test_keccak_fault_fails(monkeypatch, keccak_cell, fault):
    module, name, broken = _keccak_faults()[fault]
    monkeypatch.setattr(module, name, broken)
    correct, checked = _run(keccak_cell)
    assert not correct, checked


def test_evm_run_with_a_forged_seal_is_not_correct(monkeypatch):
    """On the CPU: set-up's execution, the window, the answers and the
    reference's own execution of the segment, with the timed prove
    returning seals that are not proofs."""
    from zeth_tpu_torch.circuits import rv32im
    forged = np.arange(64, dtype=np.uint32)
    monkeypatch.setattr(rv32im, "prove_segment",
                        lambda *args, **kwargs: (forged, forged))
    correct, checked = _run(_evm_cell())
    assert not correct and checked["seals_rejected"]["value"] >= 1
    assert checked["proves_failed"]["value"] == 0


def test_evm_sound_control_and_altered_seal(card, monkeypatch):
    """On the card: a po2=14 segment takes minutes to prove on a CPU."""
    correct, checked = _run(_evm_cell(), card)
    assert correct, checked
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.zkp import fri
    prove = rv32im.prove_segment
    with monkeypatch.context() as m:
        m.setattr(fri, "QUERIES", fri.QUERIES - 1)
        correct, checked = _run(_evm_cell(), card)
        assert not correct and checked["seals_rejected"]["value"] >= 1

    def seal_altered(*args, **kwargs):
        seal, paging_seal = prove(*args, **kwargs)
        return _flip(seal), paging_seal
    with monkeypatch.context() as m:
        m.setattr(rv32im, "prove_segment", seal_altered)
        correct, checked = _run(_evm_cell(), card)
        assert not correct and checked["seals_rejected"]["value"] >= 1
