"""The port's chain verifier and zkvm receipt API against zeth_tpu's.

``verify_segments`` / ``verify_chain`` of ``zeth_tpu_torch`` run on the
port's CPU seals of the fixture spin segment (tests/test_torch_rv32im.py
holds them equal to the JAX package's), must accept them with the JAX
package's result, and must reject the forgeries the JAX package rejects.
``zkvm.LocalProver(device="cpu")`` proves ``echo_input(16)`` into a
receipt that verifies, under its image ID only. With ZETH_E2E=1 the
three accelerator guests are proved and verified as receipts too, with
their forged-seal rejections (tests/test_zkvm_e2e.py's cases).
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu import zkvm as JZ
from zeth_tpu.circuits import rv32im as JRV
from zeth_tpu_torch import zkvm as TZ
from zeth_tpu_torch.circuits import rv32im as TRV
from zeth_tpu_torch.executor import (Executor, compute_image_id, guests,
                                     load_image)
from zeth_tpu_torch.zkp import proof as TPF

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")


@functools.lru_cache(maxsize=None)
def _spin():
    """(seal, paging seal, claim, image addrs, image words, entry) of the
    fixture spin segment, proved by the port on the CPU."""
    with open(FIXTURE) as f:
        fx = json.load(f)["spin"]
    elf = guests.spin(fx["spin_iters"])
    entry, ia, iw = load_image(elf)
    res = Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
    seal, pg_seal = TRV.prove_segment(res.segments[0], ia, iw, device="cpu")
    claim = TZ.ReceiptClaim(image_id=compute_image_id(elf),
                            journal_digest=hashlib.sha256(res.journal).digest(),
                            exit_code=res.exit_code)
    return seal, pg_seal, claim, ia, iw, entry


def _publics(seal):
    return [int(p) for p in TPF.decode(seal).publics]


def test_verify_segments_and_chain_equal_reference():
    seal, pg_seal, claim, ia, iw, entry = _spin()
    got = TRV.verify_segments([seal], [pg_seal], claim, ia, iw, entry,
                              device="cpu")
    pubs, pg_pubs = [_publics(seal)], [_publics(pg_seal)]
    want = JRV.verify_chain(pubs, claim, ia, iw, entry,
                            paging_publics_list=pg_pubs)
    assert got == want
    assert TRV.verify_chain(pubs, claim, ia, iw, entry,
                            paging_publics_list=pg_pubs) == want


def _forge(kind):
    """(publics, paging publics, claim) with one forgery of `kind`."""
    seal, pg_seal, claim, _, _, _ = _spin()
    pubs, pg_pubs = _publics(seal), _publics(pg_seal)
    if kind == "exit_code":
        claim = TZ.ReceiptClaim(claim.image_id, claim.journal_digest, 1)
    elif kind == "journal":
        claim = TZ.ReceiptClaim(claim.image_id,
                                hashlib.sha256(b"forged").digest(), 0)
    else:
        pg_pubs[16] ^= 1                 # a pre-root limb
    return pubs, pg_pubs, claim


@pytest.mark.parametrize("kind", ["exit_code", "journal", "pre_root"])
def test_verify_chain_rejects_like_reference(kind):
    _, _, _, ia, iw, entry = _spin()
    pubs, pg_pubs, claim = _forge(kind)
    with pytest.raises(JZ.VerificationError):
        JRV.verify_chain([pubs], claim, ia, iw, entry,
                         paging_publics_list=[pg_pubs])
    with pytest.raises(TZ.VerificationError):
        TRV.verify_chain([pubs], claim, ia, iw, entry,
                         paging_publics_list=[pg_pubs])


def test_verify_segments_rejects_post_root_like_reference():
    """A flipped post-root limb in the paging seal: one segment has no
    next pre-root to chain to, so the paging STARK rejects it."""
    seal, pg_seal, claim, ia, iw, entry = _spin()
    pf = TPF.decode(pg_seal)
    pf.publics = list(pf.publics)
    pf.publics[32] ^= 1
    bad = TPF.encode(pf)
    with pytest.raises(JZ.VerificationError):
        JRV.verify_segments([seal], [bad], claim, ia, iw, entry)
    with pytest.raises(TZ.VerificationError):
        TRV.verify_segments([seal], [bad], claim, ia, iw, entry,
                            device="cpu")


def test_dev_mode_receipt_needs_dev_mode(monkeypatch):
    elf = guests.sum_loop(10)
    monkeypatch.setenv("ZETH_DEV_MODE", "1")
    prover = TZ.default_prover()
    assert isinstance(prover, TZ.DevModeProver)
    info = prover.prove(TZ.ExecutorEnv.builder().build(), elf)
    assert isinstance(info.receipt.inner, TZ.FakeInner)
    info.receipt.verify(compute_image_id(elf))
    monkeypatch.delenv("ZETH_DEV_MODE")
    assert isinstance(TZ.default_prover(device="cpu"), TZ.LocalProver)
    with pytest.raises(TZ.VerificationError, match="dev mode"):
        info.receipt.verify(compute_image_id(elf))


def test_local_prover_receipt_verifies_under_its_image_only():
    elf = guests.echo_input(16)
    env = TZ.ExecutorEnv.builder().write_slice(bytes(range(16))).build()
    info = TZ.LocalProver(device="cpu").prove(env, elf)
    receipt = info.receipt
    assert receipt.journal == bytes(range(16))
    assert info.stats.segments == len(receipt.inner.seals) == 1
    receipt.verify(compute_image_id(elf), device="cpu")
    with pytest.raises(TZ.VerificationError, match="image id"):
        receipt.verify(compute_image_id(guests.echo_input(17)), device="cpu")


def test_succinct_receipt_raises(monkeypatch):
    """Under ZETH_SUCCINCT=1 the prover with no device runs on the card:
    where there is none it raises rather than prove on the CPU."""
    monkeypatch.setenv("ZETH_SUCCINCT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TZ.LocalProver().prove(TZ.ExecutorEnv.builder().build(),
                               guests.echo_input(8))


def test_paging_extras_equal_reference():
    """The companion bindings a segment's lift claim pins, as the JAX
    package's LocalProver reads them from the paging proof."""
    from zeth_tpu.circuits.paging import PagingAir as JPagingAir
    _, pg_seal, _, _, _, _ = _spin()
    pg = TPF.decode(pg_seal)
    got = TZ.paging_extras(pg)
    ppg = JPagingAir.parse_publics(_publics(pg_seal))
    want = (np.asarray(pg.roots["main"], np.uint64), ppg["d0"], ppg["d1"],
            ppg["g4"], ppg["g5"])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _succinct_receipt(fault):
    """A succinct receipt of the fixture spin segment whose root seal is
    not a proof, with one more `fault` in what it claims."""
    seal, pg_seal, claim, ia, iw, entry = _spin()
    with open(FIXTURE) as f:
        elf = guests.spin(json.load(f)["spin"]["spin_iters"])
    journal = Executor(elf, segment_po2=12).run().journal
    pg = TPF.decode(pg_seal)
    inner = TZ.SuccinctInner(
        root_seal=np.zeros(16, np.uint32),
        segment_publics=[_publics(seal)], segment_po2s=[11],
        segment_extras=[TZ.paging_extras(pg)], paging_po2s=[pg.po2],
        paging_publics=[_publics(pg_seal)], image_addrs=ia,
        image_words=iw, entry_pc=entry, accel_publics=[])
    if fault == "image":
        inner.entry_pc += 4
    elif fault == "count":
        inner.paging_po2s = []
    elif fault == "unknown_kind":
        inner.accel_publics = [("blake", 6, [0])]
    elif fault == "duplicate_kind":
        inner.accel_publics = [("sha", 6, [0]), ("sha", 6, [0])]
    return TZ.Receipt(journal=journal, claim=claim, inner=inner)


@pytest.mark.parametrize("fault, why", [
    ("image", "program image"), ("count", "count mismatch"),
    ("unknown_kind", "unknown accelerator"),
    ("duplicate_kind", "duplicate accelerator"), ("seal", "succinct receipt")])
def test_succinct_receipt_rejects_malformed(fault, why):
    """The succinct branch of Receipt.verify rejects a receipt whose
    claims do not fit together before any STARK work, and a root seal
    that is not a proof as a failed verification."""
    receipt = _succinct_receipt(fault)
    with pytest.raises(TZ.VerificationError, match=why):
        receipt.verify(receipt.claim.image_id, device="cpu")


def test_input_bytes_roundtrip():
    raw = TZ.to_zkvm_input_bytes(b"abcde")
    assert len(raw) % 4 == 0
    assert TZ.from_zkvm_input_bytes(raw) == b"abcde"
    assert raw == JZ.to_zkvm_input_bytes(b"abcde")
    claim = TZ.ReceiptClaim(np.arange(8, dtype=np.uint64),
                            hashlib.sha256(b"j").digest(), 0)
    np.testing.assert_array_equal(
        claim.digest(),
        JZ.ReceiptClaim(claim.image_id, claim.journal_digest, 0).digest())


def test_bigint_ops_equal_reference_conversion():
    rows = np.random.default_rng(0).integers(0, 2**32, (5, 48),
                                             dtype=np.uint64)
    want = [tuple(sum(int(row[12 * j + w]) << (32 * w) for w in range(12))
                  for j in range(3)) for row in rows]
    assert TZ.bigint_ops(rows) == want


def _accel_guest(kind):
    from zeth_tpu_torch.hash.sha256 import IV, pad_message
    if kind == "keccak":
        return guests.keccak_guest(2)
    if kind == "bigint":
        return guests.bigint_guest(1234567, 7654321, (1 << 31) - 1, reps=2)
    return guests.sha256_guest([int(w) for w in IV],
                               [int(w) for w in pad_message(b"abc")[0]])


@pytest.mark.parametrize("kind", ["keccak", "bigint", "sha"])
def test_accelerator_guest_receipt_live(kind):
    """tests/test_zkvm_e2e.py's accelerator cases through the port: the
    batch seal discharges the segment's bound IO (resolve), and a forged
    batch seal is rejected."""
    if os.environ.get("ZETH_E2E", "0") != "1":
        pytest.skip("set ZETH_E2E=1: each receipt proves and verifies for "
                    "about a minute on the CPU")
    elf = _accel_guest(kind)
    info = TZ.LocalProver(device="cpu").prove(
        TZ.ExecutorEnv.builder().build(), elf)
    receipt = info.receipt
    if kind == "bigint":
        a, b, m = 1234567, 7654321, (1 << 31) - 1
        assert int.from_bytes(receipt.journal, "little") == a * b % m * b % m
    if kind == "sha":
        got = b"".join(int.from_bytes(receipt.journal[4 * i:4 * i + 4],
                                      "little").to_bytes(4, "big")
                       for i in range(8))
        assert got == hashlib.sha256(b"abc").digest()
    receipt.verify(compute_image_id(elf), device="cpu")
    attr = f"{kind}_seal"
    seal = getattr(receipt.inner, attr)
    if kind == "keccak":
        # without the accelerator seal the chain recomputes the IO
        setattr(receipt.inner, attr, None)
        receipt.verify(compute_image_id(elf), device="cpu")
    bad = seal.copy()
    bad[100] ^= 1
    setattr(receipt.inner, attr, bad)
    with pytest.raises(TZ.VerificationError):
        receipt.verify(compute_image_id(elf), device="cpu")


@pytest.fixture(scope="module")
def keccak_fixture_seal():
    """The fixture's 2-permutation keccak batch, proved by the port on the
    CPU and held to the fixture digest (the JAX package's seal)."""
    from zeth_tpu_torch.circuits import keccak as TK
    with open(FIXTURE) as f:
        fx = json.load(f)["keccak"]
    lanes = np.random.default_rng(fx["seed"]).integers(
        0, 2**64, (fx["nperm"], 25), dtype=np.uint64)
    seal, _ = TK.prove_batch(lanes, device="cpu")
    assert hashlib.sha256(np.asarray(seal, "<u4").tobytes()).hexdigest() \
        == fx["seal_sha256"]
    return seal


def test_missing_card_is_raised_not_a_rejected_seal(monkeypatch,
                                                    keccak_fixture_seal):
    """With no card, resolving a valid accelerator seal, and verifying a
    segments receipt that carries it, raise the device error: they do not
    report the receipt as rejected."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inner = TZ.SegmentsInner(keccak_seal=keccak_fixture_seal)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TZ._resolve_accelerators(inner)
    receipt = TZ.Receipt(journal=b"", claim=TZ.ReceiptClaim(
        image_id=np.zeros(8, np.uint64),
        journal_digest=hashlib.sha256(b"").digest(), exit_code=0),
        inner=inner)
    with pytest.raises(RuntimeError, match="CUDA device"):
        receipt.verify(np.zeros(8, np.uint64))


def test_flipped_accelerator_seal_is_rejected(keccak_fixture_seal):
    seal = keccak_fixture_seal
    words, big, sha = TZ._resolve_accelerators(
        TZ.SegmentsInner(keccak_seal=seal), "cpu")
    assert big is None and sha is None and len(words) == 2 * 100
    bad = seal.copy()
    bad[bad.shape[0] // 2] ^= 1
    with pytest.raises(TZ.VerificationError, match="keccak accelerator seal"):
        TZ._resolve_accelerators(TZ.SegmentsInner(keccak_seal=bad), "cpu")
