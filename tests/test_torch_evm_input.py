"""The port's stateless-client front end against zeth_tpu's.

The port proves the stateless-client (EVM) guest through jax-free copies
of the application layer: keccak, RLP, the trie, the transaction and input
models, the C compiler with its guest sources, and the guest input
encoder. Each must give what ``zeth_tpu``'s module gives on the same
input (tolerance 0: bytes and integers): the compiled guest ELF, the
encoded input of both fixture blocks, the parsed input's fields, hashes,
RLP round trips, witness tries, and an untraced execution of the smaller
fixture block through the port's executor.
"""

import functools
import glob
import json
import os

import numpy as np
import pytest

from zeth_tpu import cc as JCC
from zeth_tpu import executor as JEX
from zeth_tpu.app import chainspec as JCS
from zeth_tpu.app import guest_input as JGI
from zeth_tpu.app import host as JHOST
from zeth_tpu.app import kzg as JKZG
from zeth_tpu.app import rlp as JRLP
from zeth_tpu.app import state as JSTATE
from zeth_tpu.app import txs as JTXS
from zeth_tpu.hash import keccak as JK
from zeth_tpu_torch import executor as TEX
from zeth_tpu_torch.app import chainspec as TCS
from zeth_tpu_torch.app import guest_input as TGI
from zeth_tpu_torch.app import host as THOST
from zeth_tpu_torch.app import kzg as TKZG
from zeth_tpu_torch.app import rlp as TRLP
from zeth_tpu_torch.app import state as TSTATE
from zeth_tpu_torch.app import txs as TTXS
from zeth_tpu_torch.hash import keccak as TK

FIXTURES = sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "fixtures",
                           "input_0x*.json")), key=os.path.getsize)
BLOCKS = [os.path.basename(p)[len("input_"):len("input_") + 10]
          for p in FIXTURES]


@functools.lru_cache(maxsize=None)
def _elfs():
    """(port's ELF, zeth_tpu's ELF), each compiled once per module. The
    reference's is compiled straight from its sources, as its
    ``build_stateless_elf`` does on a miss, past its ELF cache file, which
    concurrent test workers write in place."""
    JGI.source_digest()          # writes the generated KZG header if absent
    want = JCC.compile_c(
        JGI.GUEST_SOURCES,
        include_dirs=[os.path.join(JGI._GUEST_DIR, "include")])
    return TGI.build_stateless_elf(), want


@functools.lru_cache(maxsize=None)
def _inputs(i: int):
    with open(FIXTURES[i]) as f:
        d = json.load(f)
    return THOST.StatelessInput.from_json(d), JHOST.StatelessInput.from_json(d)


def test_two_fixture_blocks_present():
    assert len(FIXTURES) == 2


def test_stateless_elf_equals_reference():
    got, want = _elfs()
    assert len(got) > 100_000
    assert got == want
    te, ta, tw = TEX.load_image(got)
    je, ja, jw = JEX.load_image(want)
    assert te == je
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tw, jw)


def test_guest_sources_equal_reference_up_to_comments():
    """The C sources are copies; only comments that name the package's
    paths differ, so the preprocessed translation units are the same."""
    assert len(TGI.GUEST_SOURCES) == len(JGI.GUEST_SOURCES)
    for t, j in zip(TGI.GUEST_SOURCES, JGI.GUEST_SOURCES):
        assert os.path.basename(t) == os.path.basename(j)
        with open(t) as f, open(j) as g:
            assert (f.read().replace("zeth_tpu_torch/", "zeth_tpu/")
                    == g.read()), os.path.basename(t)


def test_kzg_setup_point_equals_reference():
    assert TKZG.setup_g2() == JKZG.setup_g2()
    tau = 0x1234567
    point = TKZG.dev_setup(tau)
    assert point == JKZG.dev_setup(tau)


@pytest.mark.parametrize("i", range(2), ids=BLOCKS)
def test_stateless_input_fields_equal_reference(i):
    t, j = _inputs(i)
    assert t.block.fields == j.block.fields
    assert t.block.encode() == j.block.encode()
    assert t.block.hash() == j.block.hash()
    name = os.path.basename(FIXTURES[i])      # input_0x<block hash>.json
    assert "0x" + t.block.hash().hex() == name[len("input_"):-len(".json")]
    assert t.transactions == j.transactions
    assert t.withdrawals == j.withdrawals
    for name in ("state", "codes", "headers"):
        assert getattr(t.witness, name) == getattr(j.witness, name)
    parent_t = THOST.Header.from_rlp(t.witness.headers[0])
    parent_j = JHOST.Header.from_rlp(j.witness.headers[0])
    assert parent_t.fields == parent_j.fields
    assert parent_t.hash() == t.block.parent_hash


@pytest.mark.parametrize("i", range(2), ids=BLOCKS)
def test_transactions_encode_equal_reference(i):
    t, j = _inputs(i)
    assert len(t.transactions) > 0
    for d in t.transactions:
        tt, jt = TTXS.Tx.from_json(d), JTXS.Tx.from_json(d)
        assert tt.encode() == jt.encode()
        assert tt.signing_hash() == jt.signing_hash()
        assert tt.type == jt.type and tt.to == jt.to


@pytest.mark.parametrize("i", range(2), ids=BLOCKS)
def test_encode_guest_input_equals_reference(i):
    t, j = _inputs(i)
    got = TGI.encode_guest_input(t, TCS.MAINNET.chain_id)
    assert TCS.MAINNET.chain_id == JCS.MAINNET.chain_id
    assert got == JGI.encode_guest_input(j, JCS.MAINNET.chain_id)
    assert len(got) % 4 == 0 and len(got) > 1000


@pytest.mark.parametrize("i", range(2), ids=BLOCKS)
def test_witness_state_trie_equals_reference(i):
    t, j = _inputs(i)
    root = THOST.Header.from_rlp(t.witness.headers[0]).state_root
    ts = TSTATE.SparseState(root, t.witness.state, t.witness.codes)
    js = JSTATE.SparseState(root, j.witness.state, j.witness.codes)
    assert ts.state.root_hash() == js.state.root_hash() == root
    assert sorted(ts.state.rlp_nodes()) == sorted(js.state.rlp_nodes())
    for d in t.transactions:
        to = TTXS.Tx.from_json(d).to
        if to is None:
            continue
        ta, ja = ts.account(to), js.account(to)
        assert (ta is None) == (ja is None)
        if ta is not None:
            assert ta.encode() == ja.encode()


def test_chainspec_tables_equal_reference():
    assert sorted(TCS.BY_CHAIN_ID) == sorted(JCS.BY_CHAIN_ID)
    for cid, spec in TCS.BY_CHAIN_ID.items():
        ref = JCS.BY_CHAIN_ID[cid]
        for ts in (0, 1_600_000_000, 1_710_338_135, 1_800_000_000):
            assert spec.active_fork(ts) == ref.active_fork(ts)
            tb, jb = spec.blob_params_at(ts), ref.blob_params_at(ts)
            assert (tb is None) == (jb is None)
            if tb is not None:
                assert vars(tb) == vars(jb)


@pytest.mark.parametrize("size", [0, 1, 31, 135, 136, 137, 272, 1000])
def test_keccak256_equals_reference(size):
    data = np.random.default_rng(size).integers(
        0, 256, size=size, dtype=np.uint8).tobytes()
    assert TK.keccak256(data) == JK.keccak256(data)
    if size == 0:
        assert TK.keccak256(b"").hex().startswith("c5d2460186f7233c")


def _random_item(rng, depth=0):
    if depth < 3 and rng.random() < 0.4:
        return [_random_item(rng, depth + 1)
                for _ in range(int(rng.integers(0, 5)))]
    if rng.random() < 0.3:
        return int(rng.integers(0, 1 << 62))
    return rng.integers(0, 256, size=int(rng.choice([0, 1, 2, 55, 56, 300])),
                        dtype=np.uint8).tobytes()


def _as_bytes(item):
    """What decoding gives back: integers come back as big-endian bytes."""
    if isinstance(item, list):
        return [_as_bytes(x) for x in item]
    if isinstance(item, int):
        return item.to_bytes((item.bit_length() + 7) // 8, "big")
    return item


@pytest.mark.parametrize("seed", range(6))
def test_rlp_round_trip_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    item = [_random_item(rng) for _ in range(8)]
    enc = TRLP.encode(item)
    assert enc == JRLP.encode(item)
    back = TRLP.decode_full(enc)
    assert back == JRLP.decode_full(enc)

    def norm(x):
        return [norm(y) for y in x] if isinstance(x, list) else bytes(x)

    assert norm(back) == _as_bytes(item)


def test_untraced_execution_equals_reference():
    """The smaller fixture block through the port's executor: the same
    journal (the block hash), segment count, cycles and exit code."""
    t, j = _inputs(0)
    got_elf, want_elf = _elfs()
    raw = TGI.encode_guest_input(t, TCS.MAINNET.chain_id)
    got = TEX.Executor(got_elf, input_bytes=raw, segment_po2=20).run()
    want = JEX.Executor(want_elf, input_bytes=raw, segment_po2=20).run()
    assert got.exit_code == want.exit_code == 0
    assert got.journal == want.journal == t.block.hash()
    assert len(got.segments) == len(want.segments) > 1
    assert (got.user_cycles, got.paging_cycles) == (want.user_cycles,
                                                    want.paging_cycles)
    assert (got.keccak_calls, got.bigint_calls, got.sha_calls) == (
        want.keccak_calls, want.bigint_calls, want.sha_calls)
    for a, b in zip(got.segments, want.segments):
        assert (a.user_cycles, a.paging_cycles, a.exit_pc) == (
            b.user_cycles, b.paging_cycles, b.exit_pc)
