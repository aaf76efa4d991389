"""The port's native EVM engine, block validation, BN254 and Groth16
against zeth_tpu's.

``zeth_tpu_torch.app.evm`` drives its own build of the engine
(``zeth_tpu_torch/app/csrc/evm.cpp``); ``host.validate_block``,
``run_block_txs``, the EIP-6110/7685 helpers and the sender recovery of
``txs`` are jax-free copies. Each must give what ``zeth_tpu``'s module
gives on the same input (tolerance 0: bytes and integers): transaction
results, state diffs, new code, post-state roots, block hashes, recovered
addresses, request hashes, the rejection of tampered blocks, pairings and
Groth16 keys and proofs.

Blocks are built by the JAX tests' own helpers (tests/test_evm.py,
test_app.py, test_prague.py), whose header hash is the JAX engine's
answer. One signature recovery costs about 5 s on the CPU in either
engine (affine secp256k1 with a bit-serial modular product), so the fast
tier validates block 101 and two one-transaction blocks, and runs the
engine comparisons with the sender given. ZETH_E2E=1 adds the
two-transaction, reverted and sha-precompile blocks, the committed
fixture blocks, the Prague block, the preflight's orphan recovery and
ecrecover on the other test_evm keys.
"""

import functools
import glob
import json
import os

import pytest

import test_app as JA
import test_evm as JE
import test_prague as JP

from zeth_tpu.app import bn254 as JB
from zeth_tpu.app import evm as JEVM
from zeth_tpu.app import host as JH
from zeth_tpu.app import state as JS
from zeth_tpu.app import txs as JT
from zeth_tpu.app.chainspec import MAINNET as JMAINNET
from zeth_tpu.zkp import groth16 as JG
from zeth_tpu_torch.app import bn254 as TB
from zeth_tpu_torch.app import evm as TEVM
from zeth_tpu_torch.app import host as TH
from zeth_tpu_torch.app import state as TS
from zeth_tpu_torch.app import txs as TT
from zeth_tpu_torch.app.chainspec import MAINNET as TMAINNET
from zeth_tpu_torch.zkp import groth16 as TG

E2E = os.environ.get("ZETH_E2E", "0") == "1"
e2e = pytest.mark.skipif(not E2E, reason="slow e2e (set ZETH_E2E=1): "
                         "signature recoveries of ~5 s each")

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "input_0x*.json")),
                  key=os.path.getsize)

BOB = b"\x44" * 20
SHA_PRECOMPILE = b"\x00" * 19 + b"\x02"
# deployment stub copying the runtime after it, then the runtime: return 42
INITCODE = bytes.fromhex("600b380380600b5f395ff3" "602a5f5260205ff3")


def _word(v: int) -> bytes:
    return v.to_bytes(32, "big")


# -- blocks, each built once per module by the JAX helpers ------------------


def _txs(name: str) -> list:
    """The JAX-signed transactions of each test_evm block."""
    sign = JE._signed_tx
    return {
        "call": [sign(0, JE.CONTRACT, 0, _word(55))],
        "create": [sign(0, None, 0, INITCODE, gas=100_000)],
        "transfer_call": [sign(0, BOB, 12345, b"", gas=21_000),
                          sign(1, JE.CONTRACT, 0, _word(77))],
        "reverted": [sign(0, JE.CONTRACT, 0, _word(5), gas=22_000)],
        "sha_precompile": [sign(0, SHA_PRECOMPILE, 0, b"abc", gas=40_000)],
    }[name]


_WITHDRAWALS = {"call": [(BOB, 2)], "transfer_call": [(BOB, 5)]}


@functools.lru_cache(maxsize=None)
def _block(name: str):
    """(input JSON, header hash by the JAX engine) of a named block."""
    if name == "101":
        d, header = JA._fixture_input()
    elif name == "prague":
        d, header, _, _ = JP.make_prague_block()
    elif name.startswith("fixture"):
        with open(FIXTURES[int(name[-1])]) as f:
            d = json.load(f)
        stem = os.path.basename(FIXTURES[int(name[-1])])
        return d, bytes.fromhex(stem[len("input_0x"):-len(".json")])
    else:
        d, header, _ = JE._mk_block(_txs(name), _WITHDRAWALS.get(name, ()))
    return d, header.hash()


def _validate(d) -> bytes:
    return TH.validate_block(TH.StatelessInput.from_json(d), TMAINNET)


@pytest.mark.parametrize("name", [
    "101", "call", "create",
    pytest.param("transfer_call", marks=e2e),
    pytest.param("reverted", marks=e2e),
    pytest.param("sha_precompile", marks=e2e),
    pytest.param("fixture0", marks=e2e),
    pytest.param("fixture1", marks=e2e),
    pytest.param("prague", marks=e2e)])
def test_validate_block_gives_the_jax_hash(name):
    d, want = _block(name)
    assert _validate(d) == want


def _tamper(d, where: str):
    bad = json.loads(json.dumps(d))
    hdr = bad["block"]["header"]
    if where == "witness_node":
        bad["witness"]["state"] = bad["witness"]["state"][1:]
    elif where == "parent_hash":
        hdr["parent_hash"] = "0x" + "22" * 32
    elif where == "gas_used":
        hdr["gas_used"] = hex(int(str(hdr["gas_used"]), 0) + 1)
    elif where == "state_root":
        hdr["state_root"] = "0x" + "ab" * 32
    elif where == "tx_value":
        bad["block"]["body"]["transactions"][0]["value"] = hex(99999)
    elif where == "requests_hash":
        h = bytearray(bytes.fromhex(hdr["requests_hash"][2:]))
        h[0] ^= 1
        hdr["requests_hash"] = "0x" + bytes(h).hex()
    return bad


@pytest.mark.parametrize("name, where", [
    ("101", "witness_node"), ("101", "parent_hash"), ("101", "gas_used"),
    ("101", "state_root"), ("call", "tx_value"),
    pytest.param("transfer_call", "gas_used", marks=e2e),
    pytest.param("transfer_call", "state_root", marks=e2e),
    pytest.param("prague", "requests_hash", marks=e2e)])
def test_tampered_block_is_rejected(name, where):
    """The tampers of test_app, test_evm and test_prague raise the port's
    ValidationError."""
    d, _ = _block(name)
    with pytest.raises(TH.ValidationError):
        _validate(_tamper(d, where))


# -- the engine, transaction by transaction (sender given) -------------------


def _engine_run(evm, state_mod, tx_mod, pre, txs, withdrawals=()):
    """Execute `txs` (JSON) with the sender given on one package's engine
    over `pre` = (state root, trie nodes, codes): ([(status, gas, logs,
    created)], state diff, new code, post-state root)."""
    state = state_mod.SparseState(*pre)
    be = evm.BlockEvm(state, {})
    be.set_block(coinbase=JE.COINBASE, number=101, timestamp=1_740_000_000,
                 gas_limit=30_000_000, basefee=7, prevrandao=b"\x00" * 32,
                 blob_basefee=0, chain_id=1)
    sender = JE._address_of(JE.PRIV_A)
    results = []
    for tj in txs:
        tx = tx_mod.Tx.from_json(tj)
        eff, tip = tx.effective_gas_price(7)
        res = be.exec_tx(sender=sender, to=tx.to, value=tx.value,
                         gas_limit=tx.gas_limit, eff_gas_price=eff,
                         tip_per_gas=tip, data=tx.data,
                         access_list=tx.access_list, nonce=tx.nonce)
        results.append((res.status, res.gas_used,
                        [(g.address, list(g.topics), g.data)
                         for g in res.logs], res.created))
    for addr, gwei in withdrawals:
        be.add_balance(addr, gwei * 10**9)
    diff, new = be.state_diff(), be.new_code()
    state.codes.update(new)
    return results, diff, new, state.calculate_state_root(diff)


def _engine_case(name: str):
    """(pre-state (root, nodes, codes), transactions JSON, withdrawals)."""
    if name == "storage":
        t, st, _ = JE._storage_pre_state({0: 7, 5: 9})
        txs = [JE._signed_tx(0, JE.CONTRACT, 0, b"\x00" * 32)]
        return (t.root_hash(), t.rlp_nodes() + st.rlp_nodes(), [JE.CODE]), \
            [JE._tx_json(tx) for tx in txs], ()
    t = JE._pre_state()[0]
    return (t.root_hash(), t.rlp_nodes(), [JE.CODE]), \
        [JE._tx_json(tx) for tx in _txs(name)], _WITHDRAWALS.get(name, ())


@pytest.mark.parametrize("name", ["transfer_call", "create", "storage",
                                  "reverted", "sha_precompile"])
def test_block_evm_equals_reference(name):
    """TxResults (status, gas, logs, created address), the state diff, new
    code and post-state root of both engines on the same transactions."""
    pre, txs, wds = _engine_case(name)
    got = _engine_run(TEVM, TS, TT, pre, txs, wds)
    want = _engine_run(JEVM, JS, JT, pre, txs, wds)
    assert got == want
    results = got[0]
    if name == "reverted":
        assert results[0][0] == 0
    else:
        assert all(r[0] == 1 for r in results)
    if name == "create":
        assert results[0][3] is not None and got[2]


def test_native_build_raises_with_make_output(tmp_path, monkeypatch):
    """A failed build of the engine raises with make's output; nothing
    stands in for it."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "evm.cpp").write_text("this is not C++\n")
    (tmp_path / "csrc" / "Makefile").write_text(
        open(os.path.join(os.path.dirname(TEVM.__file__), "csrc",
                          "Makefile")).read())
    monkeypatch.setattr(TEVM, "_DIR", str(tmp_path))
    monkeypatch.setattr(TEVM, "_SO", str(tmp_path / "csrc" / "libevm.so"))
    with pytest.raises(RuntimeError, match="make exit"):
        TEVM._lib()


def test_logs_bloom_receipt_and_trie_root_equal():
    logs_t = [TEVM.Log(JE.CONTRACT, [b"\xee" + b"\x00" * 31], b"\x01" * 40)]
    logs_j = [JEVM.Log(JE.CONTRACT, [b"\xee" + b"\x00" * 31], b"\x01" * 40)]
    assert TEVM.logs_bloom(logs_t) == JEVM.logs_bloom(logs_j)
    for tx_type in (0, 2):
        assert TEVM.encode_receipt(tx_type, 1, 50_000, logs_t) == \
            JEVM.encode_receipt(tx_type, 1, 50_000, logs_j)
    items = [bytes([i]) * (i + 1) for i in range(20)]
    assert TEVM.trie_root(items) == JEVM.trie_root(items)


# -- Prague: deposits, requests, authorizations ------------------------------


def _deposit_payloads():
    good = JP._deposit_abi_payload()
    out = [good, good[:-1]]
    for i in (31, 200, 575):            # an offset, a length, the padding
        bad = bytearray(good)
        bad[i] ^= 1
        out.append(bytes(bad))
    return out


def _outcome(fn, error, data):
    try:
        return fn(data)
    except error as e:
        return ("rejected", str(e))


def test_parse_deposit_log_equal():
    outs = [(_outcome(TH._parse_deposit_log, TH.ValidationError, d),
             _outcome(JH._parse_deposit_log, JH.ValidationError, d))
            for d in _deposit_payloads()]
    for got, want in outs:
        assert got == want
    assert len(outs[0][0]) == 192
    assert outs[2][0][0] == "rejected"


def _requests_run(evm, state_mod, tx_mod, host, spec):
    """The deposit-contract call of the Prague block, then the EIP-7685
    requests hash over its logs and the request contracts' outputs."""
    t, _, codes = JP._pre_state()
    state = state_mod.SparseState(t.root_hash(), t.rlp_nodes(), codes)
    be = evm.BlockEvm(state, {})
    be.set_block(coinbase=JE.COINBASE, number=101, timestamp=JP.TS_PRAGUE,
                 gas_limit=30_000_000, basefee=7, prevrandao=b"\x00" * 32,
                 blob_basefee=1, chain_id=1)
    be.set_fork(is_prague=True)
    tx = tx_mod.Tx.from_json(JP._tx_json(JP._prague_txs(b"")[2]))
    eff, tip = tx.effective_gas_price(7)
    res = be.exec_tx(sender=JE._address_of(JE.PRIV_A), to=tx.to,
                     value=tx.value, gas_limit=tx.gas_limit,
                     eff_gas_price=eff, tip_per_gas=tip, data=tx.data,
                     nonce=0)
    logs = [(g.address, list(g.topics), g.data) for g in res.logs]
    return res.status, logs, host._compute_requests_hash(be, spec, res.logs)


def test_compute_requests_hash_equal():
    got = _requests_run(TEVM, TS, TT, TH, TMAINNET)
    want = _requests_run(JEVM, JS, JT, JH, JMAINNET)
    assert got == want
    status, logs, _ = got
    assert status == 1 and logs[0][1][0] == TH.DEPOSIT_EVENT_TOPIC


def test_sender_and_authority_recovery_equal():
    """``Tx.recover_sender`` / ``sender`` of both packages on the same
    signature (test_evm's PRIV_A), and the port's
    ``Authorization.authority`` against the signer's address, which
    test_prague holds the JAX package's authority equal to (one recovery
    fewer: each costs ~5 s)."""
    tj = JE._tx_json(JE._signed_tx(0, JE.CONTRACT, 0, _word(55)))
    got, want = TT.Tx.from_json(tj), JT.Tx.from_json(tj)
    alice = got.recover_sender()
    assert alice == want.recover_sender() == JE._address_of(JE.PRIV_A)
    a = JP._signed_auth(JP.DELEGATE, 5)
    ta = TT.Authorization(chain_id=a.chain_id, address=a.address,
                          nonce=a.nonce, y_parity=a.y_parity, r=a.r, s=a.s)
    assert ta.signing_hash() == a.signing_hash()
    assert ta.authority() == alice
    # no recovery is tried on a bad parity; the RPC sender stands alone
    ta.y_parity = 2
    assert ta.authority() is None
    got.r = got.s = 0
    got.from_field = alice
    assert got.sender() == alice


@e2e
@pytest.mark.parametrize("priv", [1, 7, 0x1234567890ABCDEF])
def test_ecrecover_equal_on_the_test_evm_keys(priv):
    h = JE.keccak256(b"message" + bytes([priv & 0xFF]))
    r, s, rec = JE._sign(h, priv)
    assert TEVM.ecrecover(h, r, s, rec) == JEVM.ecrecover(h, r, s, rec) \
        == JE._address_of(priv)


def test_ecrecover_rejects_like_reference():
    h = b"\x01" * 32
    for r, s, rec in ((0, 5, 0), (5, 0, 1), (JE.N, 5, 0), (5, 5, 2)):
        assert TEVM.ecrecover(h, r, s, rec) is None
        assert JEVM.ecrecover(h, r, s, rec) is None


# -- the preflight witness (the proxy's fallback) ----------------------------


def test_preflight_witness_equals_reference():
    """``execution_witness`` over test_evm's fake upstream (no native
    debug_executionWitness) assembles the JAX package's witness."""
    from zeth_tpu.app import rpc_proxy as JR
    from zeth_tpu_torch.app import rpc_proxy as TR
    d, _ = _block("call")
    header = JH.Header.from_json(d["block"]["header"])
    parent = bytes.fromhex(d["witness"]["headers"][0][2:])
    ups = [JE._FakeUpstream(d, header, parent) for _ in range(2)]
    got = TR.execution_witness(ups[0], hex(header.number), chain_id=1)
    want = JR.execution_witness(ups[1], hex(header.number), chain_id=1)
    assert got == want
    assert "eth_getProof" in ups[0].calls and ups[0].calls == ups[1].calls


@e2e
@pytest.mark.parametrize("branch_sibling", [False, True])
def test_preflight_orphan_recovery_equals_reference(branch_sibling):
    """The orphan recovery of test_evm's minimal-proof upstream: un-merge
    of a leaf sibling, or the storage-range hunt for a branch one."""
    from zeth_tpu.app import rpc_proxy as JR
    from zeth_tpu_torch.app import rpc_proxy as TR
    slots = dict(zip((0,) + JE._find_orphan_slots(branch_sibling),
                     (7, 9, 11)))
    parent, header, txs = JE._mk_storage_block(slots)
    ups = [JE._MinimalProofUpstream(parent, header, txs, slots)
           for _ in range(2)]
    got = TR.execution_witness(ups[0], hex(header.number), chain_id=1)
    want = JR.execution_witness(ups[1], hex(header.number), chain_id=1)
    assert got == want
    assert ("debug_storageRangeAt" in ups[0].calls) == branch_sibling


# -- BN254: pairings, the 0x08 precompile, Groth16 ---------------------------


G1 = (1, 2)
G2 = ((10857046999023057135944570762232829481370756359578518086990519993285655852781,
       11559732032986387107991004021392285783925812861821192530917403151452391805634),
      (8495653923123431417604973247489272438418190587263600148770280649306958101930,
       4082367875863433681332203403145435568316851327593401208105741076214120093531))


def test_pairing_check_equal_on_the_test_bn254_vectors():
    a, b = 13, 29
    cases = [
        [(TG.g1_mul(G1, a), TB.g2_mul(G2, b)),
         (TG.g1_mul(G1, a * b), TB.g2_neg(G2))],
        [(TG.g1_mul(G1, a), TB.g2_mul(G2, b)),
         (TG.g1_mul(G1, a * b + 1), TB.g2_neg(G2))],
        []]
    for pairs in cases:
        assert TB.pairing_check(pairs) == JB.pairing_check(pairs)
    assert [TB.pairing_check(p) for p in cases] == [True, False, True]
    assert TB.pairing(G2, G1) == JB.pairing(G2, G1)
    with pytest.raises(ValueError):
        TB.pairing_check([((1, 3), G2)])


def test_pairing_precompile_in_a_transaction_equal():
    """test_bn254's 0x08 call with a valid pair product, through both
    engines: the port's callback runs the port's bn254."""
    alice = b"\x11" * 20

    def run(evm, state_mod, trie_mod, account, keccak256):
        t = trie_mod.Trie()
        t.insert(keccak256(alice), account(0, 10**18, trie_mod.EMPTY_ROOT,
                                           state_mod.EMPTY_CODE_HASH).encode())
        be = evm.BlockEvm(state_mod.SparseState(t.root_hash(),
                                                t.rlp_nodes()), {})
        be.set_block(coinbase=b"\x33" * 20, number=1, timestamp=1,
                     gas_limit=10**7, basefee=0, prevrandao=b"\x00" * 32,
                     blob_basefee=0, chain_id=1)

        def enc_pair(p1, q2):
            return b"".join(v.to_bytes(32, "big") for v in (
                p1[0], p1[1], q2[0][1], q2[0][0], q2[1][1], q2[1][0]))

        out = []
        for c in (27, 28):                      # valid, then invalid product
            data = enc_pair(TG.g1_mul(G1, 3), TB.g2_mul(G2, 9)) + \
                enc_pair(TG.g1_mul(G1, c), TB.g2_neg(G2))
            res = be.exec_tx(sender=alice, to=b"\x00" * 19 + b"\x08",
                             value=0, gas_limit=500_000, eff_gas_price=0,
                             tip_per_gas=0, data=data, nonce=len(out))
            out.append((res.status, res.gas_used))
        return out, be.state_diff()

    from zeth_tpu.app import trie as JTR
    from zeth_tpu.hash.keccak import keccak256 as jk
    from zeth_tpu_torch.app import trie as TTR
    from zeth_tpu_torch.hash.keccak import keccak256 as tk
    got = run(TEVM, TS, TTR, TS.Account, tk)
    assert got == run(JEVM, JS, JTR, JS.Account, jk)
    assert got[0][0][0] == 1 and got[0][0][1] > 45000 + 68000 + 21000


def _r1cs(mod):
    return mod.R1CS(n_wires=5, n_pub=1, constraints=[
        ({2: 1}, {2: 1}, {3: 1}),                 # x * x = x2
        ({3: 1}, {2: 1}, {4: 1}),                 # x2 * x = x3
        ({4: 1, 2: 1, 0: 5}, {0: 1}, {1: 1}),     # (x3 + x + 5) * 1 = out
    ])


def test_groth16_setup_and_prove_equal_and_cross_verify():
    """test_bn254's x^3 + x + 5 circuit: with the same rng both packages
    give equal keys and proofs, each verifies the other's proof, and both
    reject a tampered public."""
    x = 3
    out = (x ** 3 + x + 5) % TB.R
    witness = [1, out, x, x * x % TB.R, x ** 3 % TB.R]

    def run(mod):
        seq = iter([1234567, 7654321, 111, 222, 333, 444, 555])
        pk = mod.setup(_r1cs(mod), rng=lambda: next(seq))
        return pk, mod.prove(pk, _r1cs(mod), witness, rng=lambda: next(seq))

    (tpk, tproof), (jpk, jproof) = run(TG), run(JG)
    assert tpk.vk.__dict__ == jpk.vk.__dict__
    assert tpk.__dict__.keys() == jpk.__dict__.keys()
    for k in tpk.__dict__:
        if k != "vk":
            assert getattr(tpk, k) == getattr(jpk, k), k
    assert tproof.__dict__ == jproof.__dict__
    TG.verify(tpk.vk, JG.Proof(**jproof.__dict__), [out])
    JG.verify(jpk.vk, TG.Proof(**tproof.__dict__), [out])
    with pytest.raises(TG.Groth16Error):
        TG.verify(tpk.vk, tproof, [(out + 1) % TB.R])
    with pytest.raises(JG.Groth16Error):
        JG.verify(jpk.vk, jproof, [(out + 1) % TB.R])
