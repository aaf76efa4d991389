"""The port's STARK prover against zeth_tpu's, seal word for seal word.

For the toy AIRs at po2=6 (as tests/test_stark.py proves them) the
port's seal must equal ``zeth_tpu.zkp.proof.encode(zeth_tpu.zkp.prover
.prove(...))``, and the reference's verifier must accept the port's
proof. The reference seals are held as SHA-256 digests in
tests/fixtures/torch_port_seals.json: the first JAX prove on the CPU
spends some two minutes compiling, so the live comparison runs with
ZETH_E2E=1. The proof-of-work grind must pick the reference's nonce.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu.circuits import toy as JT
from zeth_tpu.zkp import proof as JPF
from zeth_tpu.zkp import transcript as JTR
from zeth_tpu.zkp import verifier as JV
from zeth_tpu_torch.circuits import toy as TT
from zeth_tpu_torch.hostmath import P
from zeth_tpu_torch.zkp import proof as TPF
from zeth_tpu_torch.zkp import prover as TP
from zeth_tpu_torch.zkp import transcript as TTR
from zeth_tpu_torch.zkp import verifier as TV

torch.set_num_threads(2)

PO2 = 6
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
E2E = os.environ.get("ZETH_E2E", "0") == "1"
AIRS = ["square_chain", "permutation"]


def _fixture(name):
    with open(FIXTURE) as f:
        return json.load(f)[name]


def _sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


def _witness(name):
    if name == "square_chain":
        return TT.SquareChainAir.witgen(PO2, x0=_fixture(name)["x0"])
    return TT.PermutationAir.witgen(PO2, seed=_fixture(name)["seed"])


def _airs(name):
    if name == "square_chain":
        return TT.SquareChainAir(), JT.SquareChainAir()
    return TT.PermutationAir(), JT.PermutationAir()


@functools.lru_cache(maxsize=None)
def _port(name):
    main, pubs = _witness(name)
    return TPF.encode(TP.prove(_airs(name)[0], main, pubs, device="cpu")), pubs


@pytest.mark.parametrize("name", AIRS)
def test_seal_equals_reference(name):
    seal, _ = _port(name)
    want = _fixture(name)
    assert seal.shape == (want["words"],)
    assert _sha(seal) == want["sha256"]


@pytest.mark.parametrize("name", AIRS)
def test_reference_verifier_accepts_port_proof(name):
    seal, pubs = _port(name)
    JV.verify(_airs(name)[1], JPF.decode(seal), pubs)


@pytest.mark.parametrize("name", AIRS)
def test_port_verifier_accepts_and_rejects(name):
    seal, pubs = _port(name)
    air = _airs(name)[0]
    proof = TPF.decode(seal)
    TV.verify(air, proof, pubs, device="cpu")
    np.testing.assert_array_equal(TPF.encode(proof), seal)
    bad = TPF.decode(seal)
    bad.taps[0, 0] = (int(bad.taps[0, 0]) + 1) % P
    with pytest.raises(TV.VerificationError):
        TV.verify(air, bad, pubs, device="cpu")


@pytest.mark.parametrize("name", AIRS)
def test_seal_equals_reference_live(name):
    if not E2E:
        pytest.skip("set ZETH_E2E=1: the JAX prove compiles for minutes")
    from zeth_tpu.zkp import prover as JP
    main, pubs = _witness(name)
    want = JPF.encode(JP.prove(_airs(name)[1], main, pubs))
    np.testing.assert_array_equal(_port(name)[0], want)


def test_grind_nonce_equals_reference(monkeypatch):
    # the reference searches 2^20 nonces per device batch; a smaller
    # batch keeps its CPU compile short and finds the same first hit
    monkeypatch.setattr(JTR, "_GRIND_BATCH", 1 << 12)
    monkeypatch.setattr(JTR, "_GRIND_JIT", None)
    bits = 10
    for tag in ("a", "b", "c"):
        jt, tt = JTR.Transcript(), TTR.Transcript()
        for t in (jt, tt):
            t.mix_values(np.array([ord(tag), 7, 9], np.uint64))
        np.testing.assert_array_equal(tt.pool, jt.pool)
        assert tt.grind(bits, device="cpu") == jt.grind(bits)
        np.testing.assert_array_equal(tt.pool, jt.pool)
        assert tt.sample() == jt.sample()


def test_grind_takes_first_hit_in_any_sub_batch(monkeypatch):
    t = TTR.Transcript()
    t.mix_values(np.array([3, 1, 4], np.uint64))
    want = TTR.grind_search(t.pool, 7, torch.device("cpu"))
    monkeypatch.setattr(TTR, "GRIND_BATCH_CPU", 24)
    assert TTR.grind_search(t.pool, 7, torch.device("cpu")) == want
    # the reference's verifier: every smaller nonce fails, this one passes
    for nonce in range(want + 1):
        c = JTR.Transcript()
        c.pool = t.pool.copy()
        assert c.check_grind(7, nonce) == (nonce == want)
