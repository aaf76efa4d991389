"""The port's accelerator AIRs (keccak, bigint2, sha256) against zeth_tpu's.

The host code is a jax-free copy, so on the same numpy inputs the port
must give the JAX package's witness, control trace, aux columns, derived
challenge, parsed publics and claims digest word for word; the bigint and
sha derived challenges are computed in bulk (``hostmath.ext_rlc``) and
are held against the JAX package's loop. The port's ``prove_batch`` on
the CPU must hash to the seal digests in
tests/fixtures/torch_port_seals.json, which are the JAX package's seals
for the same inputs: with ZETH_E2E=1 they are recomputed live by
``zeth_tpu.circuits.*.prove_batch`` (minutes of XLA compile each).
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu import hostmath as JH
from zeth_tpu.circuits import bigint2 as JB
from zeth_tpu.circuits import keccak as JK
from zeth_tpu.circuits import sha256 as JS
from zeth_tpu.zkp import verifier as JV
from zeth_tpu_torch import hostmath as TH
from zeth_tpu_torch.circuits import bigint2 as TB
from zeth_tpu_torch.circuits import keccak as TK
from zeth_tpu_torch.circuits import sha256 as TS
from zeth_tpu_torch.hash import keccak as TKH
from zeth_tpu_torch.hash import sha256 as TSH
from zeth_tpu_torch.zkp import air as TAIR
from zeth_tpu_torch.zkp import proof as TPF
from zeth_tpu_torch.zkp import verifier as TV

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
KINDS = ["keccak", "bigint", "sha"]
MODS = {"keccak": (JK, TK, "KeccakAir"), "bigint": (JB, TB, "Bigint2Air"),
        "sha": (JS, TS, "Sha256Air")}
CHAL = np.array([[87654321, 5, 3, 11]], dtype=np.uint64)

SECP_P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


def _inputs(kind, n=2, seed=3):
    """prove_batch arguments of a small random batch."""
    rng = np.random.default_rng(seed)
    if kind == "keccak":
        return (rng.integers(0, 2**64, (n, 25), dtype=np.uint64),)
    if kind == "bigint":
        ops = [(int.from_bytes(rng.bytes(32), "big") % SECP_P,
                int.from_bytes(rng.bytes(32), "big") % SECP_P, SECP_P)
               for _ in range(n)]
        return (ops + [(3, 5, 7)],)
    return (rng.integers(0, 2**32, (n, 8), dtype=np.uint64),
            rng.integers(0, 2**32, (n, 16), dtype=np.uint64))


def _fixture_inputs(kind):
    """The fixture batch of `kind` (chip_smoke.py builds the same)."""
    fx = _fixture()[kind]
    if kind == "keccak":
        return (np.random.default_rng(fx["seed"]).integers(
            0, 2**64, (fx["nperm"], 25), dtype=np.uint64),)
    if kind == "bigint":
        return ([tuple(op) for op in fx["ops"]],)
    rng = np.random.default_rng(fx["seed"])
    return (rng.integers(0, 2**32, (fx["nc"], 8), dtype=np.uint64),
            rng.integers(0, 2**32, (fx["nc"], 16), dtype=np.uint64))


def _airs(kind):
    jm, tm, cls = MODS[kind]
    return getattr(jm, cls)(), getattr(tm, cls)()


@functools.lru_cache(maxsize=None)
def _witness(kind):
    """(po2, publics, main) of a small batch, from the port's witgen."""
    _, tm, cls = MODS[kind]
    args = _inputs(kind)
    po2 = tm.choose_po2(len(args[0]))
    main, pubs = getattr(tm, cls).witgen(*args, po2)
    return po2, pubs, main


def _aux(air, main, pubs):
    chal = np.concatenate(
        [CHAL, np.asarray(air.derived_challenges(pubs, CHAL), np.uint64)])
    return air.build_aux(main.astype(np.uint64), chal)


@pytest.mark.parametrize("kind", KINDS)
def test_witgen_and_control_equal_reference(kind):
    jm, tm, cls = MODS[kind]
    args = _inputs(kind)
    po2 = tm.choose_po2(len(args[0]))
    assert jm.choose_po2(len(args[0])) == po2
    jmain, jpubs = getattr(jm, cls).witgen(*args, po2)
    _, tpubs, tmain = _witness(kind)
    np.testing.assert_array_equal(tmain, jmain)
    assert [int(p) for p in tpubs] == [int(p) for p in jpubs]
    ja, ta = _airs(kind)
    np.testing.assert_array_equal(ta.control_trace(po2),
                                  ja.control_trace(po2))
    assert (ta.name, ta.main_cols, ta.control_cols, ta.aux_cols) == \
        (ja.name, ja.main_cols, ja.control_cols, ja.aux_cols)


@pytest.mark.parametrize("kind", KINDS)
def test_derived_challenges_and_aux_equal_reference(kind):
    _, pubs, main = _witness(kind)
    ja, ta = _airs(kind)
    np.testing.assert_array_equal(
        np.asarray(ta.derived_challenges(pubs, CHAL), np.uint64),
        np.asarray(ja.derived_challenges(pubs, CHAL), np.uint64))
    np.testing.assert_array_equal(_aux(ta, main, pubs), _aux(ja, main, pubs))


@pytest.mark.parametrize("nop", [1, 11, 97])
def test_bulk_rlc_equals_reference_loop(nop):
    """The bigint derived challenge (96 limbs per op; 97 ops is 9,312
    limbs, not a multiple of the 1,024-limb block) and the sha one (64
    limbs per compression) against the JAX package's per-limb loops."""
    rng = np.random.default_rng(nop)
    pubs = [nop] + [int(x) for x in rng.integers(0, 1 << 16, 96 * nop)]
    ja, ta = JB.Bigint2Air(), TB.Bigint2Air()
    np.testing.assert_array_equal(ta.derived_challenges(pubs, CHAL),
                                  ja.derived_challenges(pubs, CHAL))
    pubs = pubs[:1 + 64 * nop]
    np.testing.assert_array_equal(
        TS.Sha256Air().derived_challenges(pubs, CHAL),
        JS.Sha256Air().derived_challenges(pubs, CHAL))


@pytest.mark.parametrize("n", [1, 1023, 1025, 3001])
def test_ext_rlc_equals_horner_loop(n):
    rng = np.random.default_rng(n)
    limbs = rng.integers(0, 1 << 16, n).astype(np.uint64)
    g = JH.ext(rng.integers(1, JH.P, 4).astype(np.uint64))
    gp = JH.ext_powers(g, n)
    want = np.zeros(4, dtype=np.uint64)
    for i, limb in enumerate(limbs):
        want = (want + np.uint64(limb) * gp[n - 1 - i]) % JH.PU
    np.testing.assert_array_equal(TH.ext_rlc(limbs, g), want)
    np.testing.assert_array_equal(TH.ext_power_table(g, n), gp)


@pytest.mark.parametrize("kind", KINDS)
def test_parse_publics_and_claims_digest_equal_reference(kind):
    jm, tm, _ = MODS[kind]
    _, pubs, _ = _witness(kind)
    io = tm.parse_publics(pubs)
    assert io == jm.parse_publics(pubs)
    np.testing.assert_array_equal(tm.claims_digest(io, device="cpu"),
                                  jm.claims_digest(io))
    with pytest.raises(ValueError):
        tm.parse_publics([])
    with pytest.raises(ValueError):
        tm.parse_publics([1, 2, 3])
    if kind != "keccak":
        bad = list(pubs)
        bad[1] = 1 << 16
        with pytest.raises(ValueError, match="out of range"):
            tm.parse_publics(bad)
    if kind == "bigint":
        with pytest.raises(ValueError, match="zero modulus"):
            tm.parse_publics([1] + [0] * (4 * TB.LIMBS))


def _tamper(kind, main, pubs):
    """One forgery per AIR from tests/test_{keccak,bigint2,sha256}_air.py."""
    main = main.copy()
    if kind == "keccak":
        main[24, TK.S_OFF + 100] ^= 1        # output row of permutation 0
    elif kind == "bigint":
        main[0, TB.R_OFF] ^= 1               # a bit of r on row 0
    else:
        main[64, TS.DIG_OFF + 3] ^= 1        # output row of compression 0
    return main


@pytest.mark.parametrize("kind", KINDS)
def test_constraints_hold_and_tamper_fails(kind):
    po2, pubs, main = _witness(kind)
    _, ta = _airs(kind)
    ctrl = ta.control_trace(po2)
    assert TAIR.check_constraints(ta, ctrl, main, _aux(ta, main, pubs),
                                  pubs, CHAL) == {}
    bad = _tamper(kind, main, pubs)
    assert TAIR.check_constraints(ta, ctrl, bad, _aux(ta, bad, pubs),
                                  pubs, CHAL) != {}


def test_keccak_permute_equals_numpy():
    st = np.random.default_rng(4).integers(0, 2**64, (5, 25), dtype=np.uint64)
    got = TKH.permute(torch.from_numpy(TKH.split_u64(st).view(np.int32)))
    np.testing.assert_array_equal(
        TKH.join_u64(got.numpy().view(np.uint32)), TKH.permute_np(st))


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(range(200))])
def test_sha256_compress_equals_hashlib(msg):
    blocks = torch.from_numpy(TSH.pad_message(msg).view(np.int32)[None])
    got = TSH.hash_blocks(blocks).numpy().view(np.uint32)[0]
    assert TSH.digest_to_bytes(got) == hashlib.sha256(msg).digest()
    pair = TSH.hash_pairs(blocks[:, 0, :8], blocks[:, 0, 8:])
    np.testing.assert_array_equal(pair, TSH.compress(
        torch.from_numpy(TSH.IV.view(np.int32)[None]), blocks[:, 0]))


@pytest.mark.parametrize("kind", KINDS)
def test_control_root_equals_reference(kind):
    """The verifier recomputes the control root the way the prover
    commits it; the JAX package's numpy recomputation gives the same."""
    po2, _, _ = _witness(kind)
    ja, ta = _airs(kind)
    JV._AIR_REGISTRY[ja.name] = ja
    TV._AIR_REGISTRY[ta.name] = ta
    assert TV._expected_control_root(ta.name, po2, torch.device("cpu")) == \
        JV._expected_control_root(ja.name, po2)


@functools.lru_cache(maxsize=None)
def _port_seal(kind):
    return MODS[kind][1].prove_batch(*_fixture_inputs(kind), device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_prove_batch_matches_fixture(kind):
    fx = _fixture()[kind]
    seal, digest = _port_seal(kind)
    assert TPF.decode(seal).po2 == fx["po2"]
    assert seal.shape[0] == fx["seal_words"]
    assert _sha(seal) == fx["seal_sha256"]
    jm, tm, _ = MODS[kind]
    np.testing.assert_array_equal(
        digest, jm.claims_digest(jm.parse_publics(TPF.decode(seal).publics)))


@pytest.mark.parametrize("kind", KINDS)
def test_verify_batch_accepts_and_rejects(kind):
    _, tm, _ = MODS[kind]
    seal, digest = _port_seal(kind)
    io = tm.verify_batch(seal, device="cpu")
    np.testing.assert_array_equal(tm.claims_digest(io, device="cpu"), digest)
    bad = seal.copy()
    bad[bad.shape[0] // 2] ^= 1
    with pytest.raises(Exception):
        tm.verify_batch(bad, device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_prove_batch_equals_reference_live(kind):
    if os.environ.get("ZETH_E2E", "0") != "1":
        pytest.skip("set ZETH_E2E=1: the JAX prove_batch compiles for "
                    "minutes on the CPU")
    jm, _, _ = MODS[kind]
    want, want_digest = jm.prove_batch(*_fixture_inputs(kind))
    seal, digest = _port_seal(kind)
    np.testing.assert_array_equal(seal, want)
    np.testing.assert_array_equal(digest, want_digest)
