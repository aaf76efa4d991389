"""The port's rv32im segment prove against zeth_tpu's.

The host code the port carries as jax-free copies (rv32im witgen and
aux, constraint capture and lowering, the paging witness) must equal
``zeth_tpu``'s host functions on executor segments. The port's
``prove_segment`` of a ``spin`` segment on the CPU must be accepted by
``zeth_tpu.circuits.rv32im.verify_segments``, and its seals must hash to
the digests in tests/fixtures/torch_port_seals.json (which chip_smoke.py
checks on the GPU). With ZETH_E2E=1 the seals are also held equal to
``zeth_tpu.circuits.rv32im.prove_segment`` itself, whose rv32im quotient
takes some fifteen minutes of XLA compile on the CPU.

The spin length (1503 iterations at segment_po2=12: one halting segment
of po2=11) is one whose two proof-of-work grinds end early, which keeps
the CPU prove in this file to a few seconds of grinding.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu.circuits import paging as JPG
from zeth_tpu.circuits import rv32im as JRV
from zeth_tpu.executor import Executor, compute_image_id, guests, load_image
from zeth_tpu.hash import pagetree as JPT
from zeth_tpu.zkp import tape as JTAPE
from zeth_tpu.zkvm import ReceiptClaim
from zeth_tpu_torch.circuits import paging as TPG
from zeth_tpu_torch import executor as TEX
from zeth_tpu_torch.executor import guests as TGUESTS
from zeth_tpu_torch.circuits import rv32im as TRV
from zeth_tpu_torch.hash import pagetree as TPT
from zeth_tpu_torch.zkp import proof as TPF
from zeth_tpu_torch.zkp import prover as TP
from zeth_tpu_torch.zkp import tape as TTAPE
from zeth_tpu_torch.zkp import verifier as TV

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
CHAL = np.array([[999999937, 3, 1, 4], [123456789, 7, 2, 1],
                 [55555333, 11, 5, 8], [77777177, 2, 9, 3],
                 [44440443, 17, 6, 2], [31313131, 5, 1, 7],
                 [27272727, 13, 4, 9]], dtype=np.uint64)


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)["spin"]


def _sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


@functools.lru_cache(maxsize=None)
def _run(guest: str):
    """(elf, entry, image addrs, image words, executor result)."""
    if guest == "spin":
        fx = _fixture()
        elf = guests.spin(fx["spin_iters"])
        res = Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
    else:
        elf = guests.memory_stress(6)
        res = Executor(elf, trace=True).run()
    entry, ia, iw = load_image(elf)
    return elf, entry, ia, iw, res


@functools.lru_cache(maxsize=None)
def _port_seals():
    """The spin segment proved by the port end to end: its own executor
    (tests/test_torch_executor.py holds it equal to the reference's),
    witgen and prover."""
    fx = _fixture()
    elf = TGUESTS.spin(fx["spin_iters"])
    _, ia, iw = TEX.load_image(elf)
    res = TEX.Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
    return TRV.prove_segment(res.segments[0], ia, iw, device="cpu")


def _boundary_extra(seg):
    from zeth_tpu import hostmath as JH
    g4 = JH.ext(CHAL[4])
    g5p = JH.ext_powers(JH.ext(CHAL[5]), 3)
    init = [(int(a), int(v)) for a, v in zip(seg.mem_addrs, seg.mem_pre)]
    fin = [(int(a), int(v)) for a, v in zip(seg.mem_addrs, seg.mem_post)]
    return {"d0": JRV._list_sum(init, g4, g5p),
            "d1": JRV._list_sum(fin, g4, g5p)}


@pytest.mark.parametrize("guest", ["spin", "memstress"])
def test_witgen_and_aux_equal_reference(guest):
    _, _, ia, iw, res = _run(guest)
    seg = res.segments[0]
    ja, ta = JRV.Rv32imAir(ia, iw), TRV.Rv32imAir(ia, iw)
    po2 = JRV.choose_po2(seg, len(ia))
    assert TRV.choose_po2(seg, len(ia)) == po2
    np.testing.assert_array_equal(ta.control_trace(po2), ja.control_trace(po2))
    jm, jp = ja.witgen(seg, po2)
    jm = jm.copy()               # the witgen buffer is reused per shape
    tm, tp = ta.witgen(seg, po2)
    np.testing.assert_array_equal(tm, jm)
    assert [int(x) for x in tp] == [int(x) for x in jp]
    extra = _boundary_extra(seg)
    jd = ja.derived_challenges(jp, CHAL, extra=extra)
    td = ta.derived_challenges(tp, CHAL, extra=extra)
    np.testing.assert_array_equal(np.asarray(td, np.uint64),
                                  np.asarray(jd, np.uint64))
    chal = np.concatenate([CHAL, np.asarray(jd, np.uint64)])
    np.testing.assert_array_equal(
        ta.build_aux(tm.astype(np.uint64), chal),
        ja.build_aux(jm.astype(np.uint64), chal))
    assert TRV.parse_publics(tp) == JRV.parse_publics(jp)


@pytest.mark.parametrize("air_name", ["rv32im", "paging"])
def test_tape_lowering_equals_reference(air_name):
    _, _, ia, iw, res = _run("spin")
    if air_name == "rv32im":
        ja, ta = JRV.Rv32imAir(ia, iw), TRV.Rv32imAir(ia, iw)
        seg = res.segments[0]
        _, pubs = ta.witgen(seg, TRV.choose_po2(seg, len(ia)))
    else:
        ja, ta = JPG.PagingAir(), TPG.PagingAir()
        pubs = TPG.PagingAir.pack_publics(*[np.zeros(4, np.uint64)] * 2,
                                          *[np.zeros(8, np.uint64)] * 2,
                                          *[np.zeros(4, np.uint64)] * 2)
    n_pub = len(TP.scalar_publics(ta, pubs))
    n_chal = ta.n_challenges + getattr(ta, "n_derived", 0)

    def chals(cap):
        return [tuple(cap.scalar(("chal", i, c)) for c in range(4))
                for i in range(n_chal)]

    jt = JTAPE.capture(ja, n_pub, chals)
    tt = TTAPE.capture(ta, n_pub, chals)
    np.testing.assert_array_equal(tt.ops, jt.ops)
    assert (tt.n_regs, tt.n_stage, tt.max_degree) == \
        (jt.n_regs, jt.n_stage, jt.max_degree)
    assert tt.leaves == jt.leaves
    assert repr(tt.scalar_prog) == repr(jt.scalar_prog)
    jl, tl = JTAPE.build_levels(jt), TTAPE.build_levels(tt)
    assert (tl.n_rows, tl.n_leaves, tl.leaf_groups, tl.has_one) == \
        (jl.n_rows, jl.n_leaves, jl.leaf_groups, jl.has_one)
    np.testing.assert_array_equal(tl.stage_rows, jl.stage_rows)
    for a, b in zip(tl.levels, jl.levels):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)
    chal_vals = CHAL[:n_chal] if n_chal <= len(CHAL) else \
        np.resize(CHAL, (n_chal, 4))
    np.testing.assert_array_equal(
        TTAPE.eval_scalars(tt, pubs[:n_pub], chal_vals),
        JTAPE.eval_scalars(jt, pubs[:n_pub], chal_vals))


def test_paging_witness_equals_reference():
    _, _, ia, iw, res = _run("memstress")
    seg = res.segments[0]
    assert len(seg.mem_addrs) > 0
    jw = JPG.segment_witness(JPT.SparsePageTree(ia, iw), seg.mem_addrs,
                             seg.mem_pre, seg.mem_post)
    tw = TPG.segment_witness(TPT.SparsePageTree(ia, iw), seg.mem_addrs,
                             seg.mem_pre, seg.mem_post)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    z4 = np.zeros(4, np.uint64)
    jm, jp = JPG.PagingAir.witgen(*jw, z4, z4)
    tm, tp = TPG.PagingAir.witgen(*tw, z4, z4)
    np.testing.assert_array_equal(tm, jm)
    assert [int(x) for x in tp] == [int(x) for x in jp]
    np.testing.assert_array_equal(TPG.PagingAir().control_trace(8),
                                  JPG.PagingAir().control_trace(8))
    sums = [TPG._touch_sum(tw[0], tw[1], tw[3], CHAL[4], CHAL[5]),
            JPG._touch_sum(jw[0], jw[1], jw[3], CHAL[4], CHAL[5])]
    np.testing.assert_array_equal(*sums)


def test_prove_segment_accepted_by_reference():
    elf, entry, ia, iw, res = _run("spin")
    assert len(res.segments) == 1
    seal, pg_seal = _port_seals()
    claim = ReceiptClaim(image_id=compute_image_id(elf),
                         journal_digest=hashlib.sha256(res.journal).digest(),
                         exit_code=0)
    JRV.verify_segments([seal], [pg_seal], claim, ia, iw, entry)


def test_port_verifier_accepts_segment():
    _, _, ia, iw, _ = _run("spin")
    seal, pg_seal = _port_seals()
    proof, pg_proof = TPF.decode(seal), TPF.decode(pg_seal)
    ppg = TPG.PagingAir.parse_publics([int(p) for p in pg_proof.publics])
    TV.verify(TPG.PagingAir(), pg_proof, [int(p) for p in pg_proof.publics],
              device="cpu")
    sampled = TV.verify(TRV.Rv32imAir(ia, iw), proof,
                        [int(p) for p in proof.publics],
                        derived_extra={"d0": ppg["d0"], "d1": ppg["d1"]},
                        extra_mix=pg_proof.roots["main"], device="cpu")
    np.testing.assert_array_equal(np.asarray(sampled[4], np.uint64),
                                  ppg["g4"])


def test_seal_digests_match_fixture():
    fx = _fixture()
    seal, pg_seal = _port_seals()
    assert TPF.decode(seal).po2 == fx["po2"]
    assert (seal.shape[0], pg_seal.shape[0]) == \
        (fx["seal_words"], fx["paging_words"])
    assert _sha(seal) == fx["seal_sha256"]
    assert _sha(pg_seal) == fx["paging_sha256"]


def test_prove_segment_equals_reference_live():
    if os.environ.get("ZETH_E2E", "0") != "1":
        pytest.skip("set ZETH_E2E=1: the JAX rv32im prove compiles for "
                    "some fifteen minutes on the CPU")
    _, _, ia, iw, res = _run("spin")
    want, want_pg = JRV.prove_segment(res.segments[0], ia, iw)
    seal, pg_seal = _port_seals()
    np.testing.assert_array_equal(seal, want)
    np.testing.assert_array_equal(pg_seal, want_pg)
