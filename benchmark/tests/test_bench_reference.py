"""The plain reference against the port at tiny sizes on the CPU."""

import hashlib
import struct

import numpy as np
import pytest
import torch

from reference import check, elf, keccakf, rv32, sha256, sponge
from reference.circuits import keccak as ref_keccak
from reference.hash import merkle as ref_merkle
from reference.hash import poseidon2 as ref_p2
from reference.zkp import stark


def test_keccakf_known_answer_and_port():
    from zeth_tpu_torch.hash import keccak as port
    zero = keccakf.permute(np.zeros((1, 25), np.uint64))
    assert int(zero[0, 0]) == 0xF1258F7940E1DDE7
    s = np.random.default_rng(1).integers(0, 2**64, (33, 25),
                                          dtype=np.uint64)
    assert (keccakf.permute(s) == port.permute_np(s)).all()
    assert keccakf.RC == port._RC
    assert (keccakf.PI_SRC == port._PI_SRC).all()
    assert (keccakf.PI_ROT == port._PI_ROT).all()


def test_sha256_compression_against_hashlib():
    msg = b"zeth"
    block = msg + b"\x80" + b"\x00" * (55 - len(msg)) + \
        struct.pack(">Q", 8 * len(msg))
    iv = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]
    out = sha256.compress(iv, list(struct.unpack(">16I", block)))
    assert b"".join(struct.pack(">I", w) for w in out) == \
        hashlib.sha256(msg).digest()


@pytest.mark.parametrize("cols", [0, 1, 15, 16, 17, 100])
def test_sponges_against_the_port(cols):
    from zeth_tpu_torch import hostmath as H
    from zeth_tpu_torch.hash import poseidon2 as port
    rows = np.random.default_rng(cols).integers(
        0, 2**31, (5, cols), dtype=np.uint64) % np.uint64(H.P)
    want = port.hash_rows_np(rows)
    assert (ref_p2.hash_rows_np(rows) == want).all()
    assert (sponge.sponge(rows) == want).all()
    mont = torch.from_numpy(H.to_monty_np(rows).view(np.int32))
    assert (H.from_monty_np(ref_p2.hash_rows(mont).numpy().view(np.uint32))
            == want).all()


def test_leaf_digests_and_tree_root_against_the_port():
    from zeth_tpu_torch.hash import merkle as port_merkle
    from zeth_tpu_torch.hash import poseidon2 as port
    m = torch.randint(0, 2**31 - 2**27, (64, 37), dtype=torch.int32,
                      generator=torch.Generator().manual_seed(3))
    assert torch.equal(ref_p2.hash_rows(m), port.leaf_hash(m))
    assert (ref_merkle.root_of_rows(m) ==
            port_merkle.commit_rows(m).root).all()


@pytest.mark.parametrize("n", [0, 1, 7, 700])
def test_rlc_against_the_port(n):
    from zeth_tpu_torch.circuits import rv32im as port
    from reference.circuits import rv32im as ref
    rng = np.random.default_rng(n)
    words = [int(w) for w in rng.integers(0, 2**32, n, dtype=np.uint64)]
    g = rng.integers(0, 2**31 - 2**27, 4, dtype=np.uint64)
    assert (ref._rlc(words, g) == port._rlc(words, g)).all()


def test_elf_image_against_the_executor():
    from zeth_tpu_torch.app import guest_input
    from zeth_tpu_torch.executor import load_image
    e = guest_input.build_stateless_elf()
    mine, port = elf.load_image(e), load_image(e)
    assert mine[0] == port[0]
    assert (mine[1] == port[1]).all() and (mine[2] == port[2]).all()


def _port_guests():
    from zeth_tpu_torch.executor import guests as g
    rng = np.random.default_rng(7)
    return {
        "sum_loop": (g.sum_loop(300), b"", 12),
        "echo_input": (g.echo_input(64), bytes(range(64)), 12),
        "muldiv_check": (g.muldiv_check(), b"", 12),
        "keccak": (g.keccak_guest(3), b"", 12),
        "bigint": (g.bigint_guest(2**255 - 19, 3**150, 2**381 - 5, reps=2),
                   b"", 12),
        "sha256": (g.sha256_guest([int(x) for x in rng.integers(
            0, 2**32, 8)], [int(x) for x in rng.integers(0, 2**32, 16)],
            reps=2), b"", 12),
        "load_store": (g.load_store(), b"", 12),
        "memory_stress": (g.memory_stress(6), b"", 13),
        "spin_cut": (g.spin(40000), b"", 14),
    }


def _fixture_blocks():
    import glob
    import os
    from conftest import BENCH
    return sorted(glob.glob(os.path.join(BENCH, "data", "input_0x*.json")))


@pytest.mark.parametrize("case", sorted(_port_guests()) + [
    f"block{i}:{po2}" for i in range(2) for po2 in (14, 17)])
def test_segment_execution_against_the_executor(case):
    """The reference's own execution of a first segment equals the port's
    executor's record: exit state, halt, journal, cycles, written words."""
    from zeth_tpu_torch.executor import Executor
    if case.startswith("block"):
        import json
        from zeth_tpu_torch.app import guest_input
        from zeth_tpu_torch.app.chainspec import MAINNET
        from zeth_tpu_torch.app.host import StatelessInput
        i, po2 = map(int, case[5:].split(":"))
        with open(_fixture_blocks()[i]) as f:
            inp = StatelessInput.from_json(json.load(f))
        e = guest_input.build_stateless_elf()
        raw = guest_input.encode_guest_input(inp, MAINNET.chain_id)
    else:
        e, raw, po2 = _port_guests()[case]
    ex = Executor(e, input_bytes=raw, segment_po2=po2)
    res = ex.run()
    seg = res.segments[0]
    entry, addrs, words = elf.load_image(e)
    run = rv32.run_segment(entry, addrs, words, raw, po2)
    assert run["exit_pc"] == seg.exit_pc
    assert run["exit_regs"] == [int(r) for r in seg.exit_regs]
    assert run["halted"] == seg.halted and run["exit_code"] == seg.exit_code
    assert run["user_cycles"] == seg.user_cycles
    if seg.halted and len(res.segments) == 1:
        assert run["journal"] == res.journal
    post = dict(zip(seg.mem_addrs.tolist(), seg.mem_post.tolist()))
    image = dict(zip(addrs.tolist(), words.tolist()))
    assert all(post[a] == v for a, v in run["written"].items())
    assert {a for a, v in post.items() if image.get(a, 0) != v} \
        <= set(run["written"])


def test_control_root_against_the_port_verifier():
    from zeth_tpu_torch.circuits.keccak import KeccakAir
    from zeth_tpu_torch.zkp import verifier as port_verifier
    port_verifier._AIR_REGISTRY[KeccakAir.name] = KeccakAir()
    want = port_verifier._expected_control_root(KeccakAir.name, 7,
                                                torch.device("cpu"))
    got = stark.control_root(ref_keccak.KeccakAir().control_trace(7), "cpu")
    assert tuple(int(v) for v in got) == want


@pytest.fixture(scope="module")
def keccak_proof():
    from zeth_tpu_torch.circuits import keccak as port
    states = np.random.default_rng(7).integers(0, 2**64, (4, 25),
                                               dtype=np.uint64)
    seal, digest = port.prove_batch(states, device="cpu")
    return states, seal, digest


def test_a_small_keccak_seal_checks(keccak_proof):
    from zeth_tpu_torch.circuits import keccak as port
    states, seal, digest = keccak_proof
    rejected, wrong, io = check.check_keccak_batch(seal, states, "cpu")
    assert (rejected, wrong) == (0, [])
    assert io.reshape(-1).tolist() == port.verify_batch(seal, device="cpu")
    assert (check.claims_digests([io])[0] == digest).all()


def test_a_tampered_keccak_seal_fails(keccak_proof):
    states, seal, _ = keccak_proof
    bad = seal.copy()
    bad[len(bad) // 2] ^= 1
    assert check.check_keccak_batch(bad, states, "cpu")[0] == 1
    other = states.copy()
    other[0, 0] ^= np.uint64(1)
    assert check.check_keccak_batch(seal, other, "cpu")[1] == \
        ["inputs", "outputs"]
