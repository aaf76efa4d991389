"""The port's recursion VM, lift/join and succinct aggregation against zeth_tpu's.

The recursion modules of ``zeth_tpu_torch`` are jax-free copies, so on the
same seeded numpy inputs they must give the JAX package's programs
(``Program.digest()``), interpreter outputs, control traces, LogUp aux,
witness streams and claim digests word for word, and the port's native
interpreter must equal its numpy one. That holds for every lift program
the main path builds: the toy AIR's, a paging proof's, an rv32im
segment's (with its paging proof's companion bindings) and the keccak,
sha and bigint batches' (the in-circuit resolve). The port's constraint check must
accept a lift program's trace over a real proof and reject tampered
streams and wrong claims. A tiny recursion program proved on the CPU must
hash to the JAX package's seal digest in tests/fixtures/
torch_port_seals.json, and the port's verifier must reject both tampers
of ``tests/test_recvm.py``.

With ZETH_E2E=1: a toy lift, join and root verify, and a succinct
``LocalProver`` receipt of ``echo_input(16)``, with their root seals held
equal to the JAX package's, proved live. Both are slow on a CPU: the toy
case takes over an hour (the JAX package's recursion prove), and the echo
receipt's recursion proofs are po2=19-20.
"""

import functools
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu.circuits.toy import SquareChainAir as JSquareChainAir
from zeth_tpu.recursion import builder as JB
from zeth_tpu.recursion import compiler as JC
from zeth_tpu.recursion import scheduler as JSCH
from zeth_tpu.recursion import succinct as JS
from zeth_tpu.recursion import vm as JVM
from zeth_tpu.zkp import proof as JPF
from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch.circuits.paging import PagingAir
from zeth_tpu_torch.circuits.toy import SquareChainAir
from zeth_tpu_torch.executor import Executor, guests, load_image
from zeth_tpu_torch.hash import poseidon2 as P2
from zeth_tpu_torch.recursion import aggregate_segments
from zeth_tpu_torch.recursion import builder as TB
from zeth_tpu_torch.recursion import compiler as TC
from zeth_tpu_torch.recursion import scheduler as TSCH
from zeth_tpu_torch.recursion import succinct as TS
from zeth_tpu_torch.recursion import vm as TVM
from zeth_tpu_torch.recursion import witgen_native
from zeth_tpu_torch.zkp import proof as TPF
from zeth_tpu_torch.zkp import prover as TP
from zeth_tpu_torch.zkp import verifier as TV
from zeth_tpu_torch.zkp.air import check_constraints

torch.set_num_threads(2)

P = H.P
E2E = os.environ.get("ZETH_E2E", "0") == "1"
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
CHAL = np.array([[3, 5, 7, 11], [13, 17, 19, 23]], dtype=np.uint64)


def _fixture(name):
    with open(FIXTURE) as f:
        return json.load(f)[name]


def _sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


# -- hand programs (tests/test_recvm.py's), built by both packages ----------


def _fma_wom(B):
    b = B.Builder()
    x = b.input()
    y = b.input()
    s = b.add(x, y)
    p = b.mul(x, y)
    b.fma(a=x, b=y, c=s, d=p, e=x, s0=2, s1=3, s2=4, imm=(1, 2, 3, 4))
    b.assert_eq(s, 12)
    return b, [5, 7]


def _native_mix(B):
    b = B.Builder()
    xs = b.inputs(6)
    acc = xs[0]
    for x in xs[1:]:
        acc = b.fma(a=acc, b=x, c=acc, d=b.ONE, s0=1, s1=5, imm=9)
    e = b.input_ext()
    b.inv(e)
    bits = b.decompose(xs[3], 31)
    d8 = b.sponge_hash(xs + bits[:10])
    b.bind_public(d8[0], 0)
    n = b.n_stream
    return b, np.arange(1, n + 1, dtype=np.uint64) * 12345 % P


def _sponge(B):
    b = B.Builder()
    b.sponge_hash(b.inputs(23))
    return b, (np.arange(23, dtype=np.uint64) * 7919 + 3) % P


def _pair_sel(bit):
    def build(B):
        rng = np.random.default_rng(1)
        left = rng.integers(0, P, 8, dtype=np.uint64)
        right = rng.integers(0, P, 8, dtype=np.uint64)
        b = B.Builder()
        lc = b.inputs(8)
        rc = b.inputs(8)
        bitc = b.bit_of(lc[0], 0)
        b.pair_hash_sel(bitc, lc, rc)
        b.pair_hash(lc, rc)
        left[0] = (left[0] & ~np.uint64(1)) | np.uint64(bit)
        return b, np.r_[left, right]
    return build


def _transcript(B):
    rng = np.random.default_rng(2)
    vals = rng.integers(0, P, 100, dtype=np.uint64)
    digest = rng.integers(0, P, 8, dtype=np.uint64)
    b = B.Builder()
    vc = b.inputs(100)
    dc = b.inputs(8)
    rt = B.RTranscript(b)
    rt.mix_values(vc)
    rt.mix_digest(dc)
    rt.sample_vec(20)
    return b, np.r_[vals, digest]


def _decompose(B):
    b = B.Builder()
    b.decompose(b.input(), 31)
    return b, [22]


UNITS = {"fma_wom": _fma_wom, "native_mix": _native_mix, "sponge": _sponge,
         "pair_sel_0": _pair_sel(0), "pair_sel_1": _pair_sel(1),
         "transcript": _transcript, "decompose": _decompose}

_FIELDS = ("typ", "addr", "mult", "rc", "s", "pub", "wf")


@functools.lru_cache(maxsize=None)
def _unit(name):
    """(port program, JAX program, stream) of one hand program."""
    tb, stream = UNITS[name](TB)
    jb, _ = UNITS[name](JB)
    return tb.build(), jb.build(), np.asarray(stream, np.uint64)


@pytest.mark.parametrize("name", list(UNITS))
def test_unit_program_equals_reference(name):
    pr, jpr, stream = _unit(name)
    for f in _FIELDS:
        np.testing.assert_array_equal(getattr(pr, f), getattr(jpr, f))
    assert (pr.n_cells, pr.n_stream) == (jpr.n_cells, jpr.n_stream)
    assert pr.digest() == jpr.digest()
    n = 1 << pr.po2()
    main, wom = TVM._witgen_py(pr, stream, n)
    jmain, jwom = JVM._witgen_py(jpr, stream, n)
    np.testing.assert_array_equal(main, jmain)
    np.testing.assert_array_equal(wom, jwom)
    # the interpreter the prover runs equals the plain one
    nmain, nwom = TVM.RecursionAir(pr).witgen(stream)
    np.testing.assert_array_equal(nmain, main)
    np.testing.assert_array_equal(nwom, wom)
    air, jair = TVM.RecursionAir(pr), JVM.RecursionAir(jpr)
    assert air.name == jair.name
    control = air.control_trace(pr.po2())
    np.testing.assert_array_equal(control, jair.control_trace(pr.po2()))
    aux = air.build_aux(main, CHAL)
    np.testing.assert_array_equal(aux, jair.build_aux(jmain, CHAL))
    # the publics are the values the program's T_PUB rows read
    pubs = [0] * TVM.N_PUB
    for r in np.nonzero(pr.pub >= 0)[0]:
        pubs[int(pr.pub[r])] = int(main[r, TVM.ML.VAL])
    bad = check_constraints(air, control, main, aux, publics=pubs,
                            challenges=CHAL)
    assert bad == {}, f"constraint violations: {bad}"


def test_unit_program_values():
    """What the hand programs compute: the FMA cells, the sponge, the
    Merkle pair select and the transcript mirror against the host."""
    from zeth_tpu_torch.zkp.transcript import Transcript
    pr, _, stream = _unit("fma_wom")
    _, wom = TVM.RecursionAir(pr).witgen(stream)
    assert tuple(wom[4]) == (12, 0, 0, 0) and tuple(wom[5]) == (35, 0, 0, 0)
    pr, _, stream = _unit("sponge")
    _, wom = TVM.RecursionAir(pr).witgen(stream)
    dig = [wom[c][0] for c in range(pr.n_cells - 8, pr.n_cells)]
    np.testing.assert_array_equal(dig, P2.hash_rows_np(stream[None])[0])
    for bit in (0, 1):
        pr, _, stream = _unit(f"pair_sel_{bit}")
        _, wom = TVM.RecursionAir(pr).witgen(stream)
        left, right = stream[:8], stream[8:]
        sel = (P2.hash_pairs_np(right[None], left[None])[0] if bit
               else P2.hash_pairs_np(left[None], right[None])[0])
        got = [wom[c][0] for c in range(pr.n_cells - 16, pr.n_cells - 8)]
        np.testing.assert_array_equal(got, sel)
    pr, _, stream = _unit("transcript")
    _, wom = TVM.RecursionAir(pr).witgen(stream)
    t = Transcript()
    t.mix_values(stream[:100])
    t.mix(stream[100:])
    want = [t.sample() for _ in range(20)]
    assert [int(wom[c][0]) for c in _transcript_samples()] == want


def _transcript_samples():
    """The sample cells of the transcript program (the builder is
    deterministic, so a second build numbers its cells the same)."""
    b = TB.Builder()
    vc = b.inputs(100)
    dc = b.inputs(8)
    rt = TB.RTranscript(b)
    rt.mix_values(vc)
    rt.mix_digest(dc)
    return rt.sample_vec(20)


def test_decompose_rejects_forged_bit():
    pr, _, stream = _unit("decompose")
    air = TVM.RecursionAir(pr)
    main, _ = air.witgen(stream)
    row = next(r for r in range(pr.n_rows) if pr.typ[r] == TVM.T_BIT)
    forged = main.copy()
    forged[row, TVM.ML.VAL + 4 * 5] ^= 1
    control = air.control_trace(pr.po2())
    aux = air.build_aux(forged, CHAL)
    bad = check_constraints(air, control, forged, aux,
                            publics=[0] * TVM.N_PUB, challenges=CHAL)
    assert bad, "forged bit not caught"


def test_witgen_raises_without_native_library(monkeypatch, tmp_path):
    """No silent fallback to the numpy interpreter: a native library that
    cannot be built or loaded raises, with make's output."""
    pr, _, stream = _unit("fma_wom")
    monkeypatch.setattr(witgen_native, "_LIB", None)
    monkeypatch.setattr(witgen_native, "_DIR", str(tmp_path))
    monkeypatch.setattr(witgen_native, "_SO",
                        str(tmp_path / "librecvm.so"))
    (tmp_path / "recvm.cpp").write_text("this is not C++\n")
    (tmp_path / "Makefile").write_text(
        "librecvm.so: recvm.cpp\n\tg++ -shared -fPIC -o $@ $<\n")
    with pytest.raises(RuntimeError, match="librecvm.so"):
        TVM.RecursionAir(pr).witgen(stream)


# -- lift programs over real proofs ---------------------------------------

# SquareChainAir at po2=9 from x0 = 27 (and 34 for a second proof), whose
# proof-of-work nonces are small (38,025 and 39,170), so the CPU prove
# grinds for about a second
TOY_PO2, TOY_X0, TOY_X0_2 = 9, 27, 34


@functools.lru_cache(maxsize=None)
def _toy_proof(x0=TOY_X0):
    air = SquareChainAir()
    main, pubs = air.witgen(TOY_PO2, x0=x0)
    return air, TP.prove(air, main, pubs, device="cpu"), pubs


@functools.lru_cache(maxsize=None)
def _spin_proofs():
    """The fixture spin segment's proof and paging proof, proved by the
    port on the CPU (their seals are the JAX package's,
    tests/test_torch_rv32im.py), and the program image."""
    from zeth_tpu_torch.circuits import rv32im as TRV
    fx = _fixture("spin")
    elf = guests.spin(fx["spin_iters"])
    _, ia, iw = load_image(elf)
    res = Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
    seal, pg_seal = TRV.prove_segment(res.segments[0], ia, iw, device="cpu")
    assert (_sha(seal), _sha(pg_seal)) == (fx["seal_sha256"],
                                           fx["paging_sha256"])
    return seal, pg_seal, ia, iw


def _accel_inputs(kind):
    """The fixture's small batch of `kind`, as prove_batch takes it
    (tests/test_torch_accel_airs.py builds the same)."""
    fx = _fixture(kind)
    if kind == "keccak":
        return (np.random.default_rng(fx["seed"]).integers(
            0, 2**64, (fx["nperm"], 25), dtype=np.uint64),)
    if kind == "bigint":
        return ([tuple(op) for op in fx["ops"]],)
    rng = np.random.default_rng(fx["seed"])
    return (rng.integers(0, 2**32, (fx["nc"], 8), dtype=np.uint64),
            rng.integers(0, 2**32, (fx["nc"], 16), dtype=np.uint64))


@functools.lru_cache(maxsize=None)
def _accel_seal(kind):
    from zeth_tpu_torch import zkvm as TZ
    seal, _ = TZ.accelerator_module(kind).prove_batch(*_accel_inputs(kind),
                                                      device="cpu")
    assert _sha(seal) == _fixture(kind)["seal_sha256"]
    return seal


def _jax_paging_extras(jpg_proof):
    """The companion bindings as zeth_tpu.zkvm builds them."""
    from zeth_tpu.circuits.paging import PagingAir as JPagingAir
    ppg = JPagingAir.parse_publics([int(p) for p in jpg_proof.publics])
    return (np.asarray(jpg_proof.roots["main"], np.uint64), ppg["d0"],
            ppg["d1"], ppg["g4"], ppg["g5"])


def _lift_case(which):
    """(port air, JAX air, port proof, JAX proof of the same seal words,
    port companion bindings, JAX companion bindings)."""
    extra = jextra = None
    if which == "toy":
        air, proof, _ = _toy_proof()
        seal = TPF.encode(proof)
        jair = JSquareChainAir()
    elif which == "paging":
        from zeth_tpu.circuits.paging import PagingAir as JPagingAir
        seal = _spin_proofs()[1]
        air, jair = PagingAir(), JPagingAir()
    elif which == "rv32im":
        from zeth_tpu.circuits.rv32im import Rv32imAir as JRv32imAir
        from zeth_tpu_torch import zkvm as TZ
        from zeth_tpu_torch.circuits.rv32im import Rv32imAir
        seal, pg_seal, ia, iw = _spin_proofs()
        air, jair = Rv32imAir(ia, iw), JRv32imAir(ia, iw)
        extra = TZ.paging_extras(TPF.decode(pg_seal))
        jextra = _jax_paging_extras(JPF.decode(pg_seal))
    else:
        import importlib
        from zeth_tpu_torch import zkvm as TZ
        seal = _accel_seal(which)
        air = TZ.accelerator_air(which)
        mod = {"keccak": "keccak", "bigint": "bigint2", "sha": "sha256"}
        jair = getattr(importlib.import_module(
            f"zeth_tpu.circuits.{mod[which]}"), type(air).__name__)()
    return air, jair, TPF.decode(seal), JPF.decode(seal), extra, jextra


def _claim_row(air, proof, extra, extra_row):
    if extra is not None:
        return extra_row(extra)
    if getattr(air, "bind_claim_main_root", False):
        return np.asarray(proof.roots["main"], np.uint64)
    return None


@functools.lru_cache(maxsize=None)
def _lift(which):
    air, jair, proof, jproof, extra, jextra = _lift_case(which)
    pubs = [int(p) for p in proof.publics]
    vp = TS.lift_program(air, proof.po2, len(pubs),
                         TS.publics_shape(air, pubs), device="cpu")
    return air, jair, proof, jproof, extra, jextra, vp


# every lift the main path makes: the toy AIR, a segment's paging proof,
# the segment itself (with the companion bindings of its paging proof),
# and the three accelerator batches (the in-circuit resolve)
@pytest.mark.parametrize("which", ["toy", "paging", "rv32im", "keccak",
                                   "sha", "bigint"])
def test_lift_program_and_stream_equal_reference(which):
    air, jair, proof, jproof, extra, jextra, vp = _lift(which)
    pubs = [int(p) for p in proof.publics]
    assert TS.publics_shape(air, pubs) == JS.publics_shape(jair, pubs)
    jvp = JS.lift_program(jair, jproof.po2, len(pubs),
                          JS.publics_shape(jair, pubs))
    assert vp.program.digest() == jvp.program.digest()
    assert vp.program.n_stream == jvp.program.n_stream
    assert (vp.layer_domains, vp.final_degree, vp.n_taps) == \
        (jvp.layer_domains, jvp.final_degree, jvp.n_taps)
    # the same seal words decoded by each package give the same stream
    x = None if extra is None else extra[:3]
    jx = None if jextra is None else jextra[:3]
    stream = TC.proof_to_stream(vp, proof, extra=x)
    assert stream.shape == (vp.program.n_stream,)
    np.testing.assert_array_equal(stream,
                                  JC.proof_to_stream(jvp, jproof, extra=jx))
    np.testing.assert_array_equal(TC.proof_to_stream(vp, jproof, extra=x),
                                  stream)
    row = _claim_row(air, proof, extra, TS._extra_row)
    jrow = _claim_row(jair, jproof, jextra, JS._extra_row)
    claim = TC.claim_digest(proof.po2, pubs, row, device="cpu")
    np.testing.assert_array_equal(claim, JC.claim_digest(proof.po2, pubs,
                                                         jrow))


def _constraints_ok(vp, stream, claim):
    rair = vp.air()
    main, _ = rair.witgen(stream)
    control = rair.control_trace(vp.program.po2())
    aux = rair.build_aux(main, CHAL)
    return check_constraints(rair, control, main, aux,
                             publics=[int(x) for x in claim],
                             challenges=CHAL)


def test_toy_lift_accepts_real_proof_and_rejects_tampers():
    _, _, proof, _, _, _, vp = _lift("toy")
    pubs = [int(p) for p in proof.publics]
    claim = TC.claim_digest(proof.po2, pubs, device="cpu")
    base = TC.proof_to_stream(vp, proof)
    assert _constraints_ok(vp, base, claim) == {}
    # a main root word, a tap component, a late opening/path word
    for pos in (len(pubs) + 3, len(pubs) + 16 + 5, vp.program.n_stream - 9):
        stream = base.copy()
        stream[pos] = (stream[pos] + 1) % P
        assert _constraints_ok(vp, stream, claim), f"tamper at {pos}"
    wrong = TC.claim_digest(proof.po2, [pubs[0] + 1, pubs[1]], device="cpu")
    assert _constraints_ok(vp, base, wrong)


def test_paging_lift_accepts_real_proof():
    """The paging lift (the in-circuit derived challenges over the page
    publics, and the claim pinning the proof's own main root)."""
    air, _, proof, _, _, _, vp = _lift("paging")
    pubs = [int(p) for p in proof.publics]
    claim = TC.claim_digest(proof.po2, pubs,
                            _claim_row(air, proof, None, None), device="cpu")
    assert _constraints_ok(vp, TC.proof_to_stream(vp, proof), claim) == {}


def test_claim_folds_equal_reference():
    rng = np.random.default_rng(5)
    claims = [rng.integers(0, P, 8, dtype=np.uint64) for _ in range(5)]
    np.testing.assert_array_equal(TS.join_claim(claims[0], claims[1]),
                                  JS.join_claim(claims[0], claims[1]))
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(TS._fold_claims(claims[:k]),
                                      JS._fold_claims(claims[:k]))
    pubs = [[1, 2], [3, 4], [5, 6]]
    extra = (rng.integers(0, P, 8, dtype=np.uint64),
             *(rng.integers(0, P, 4, dtype=np.uint64) for _ in range(4)))
    extras = [None, extra, None]
    np.testing.assert_array_equal(
        TS.expected_root_claim([9, 9, 10], pubs, extras, device="cpu"),
        JS.expected_root_claim([9, 9, 10], pubs, extras))
    c1 = TC.claim_digest(9, [1, 2], device="cpu")
    c2 = TC.claim_digest(9, [3, 4], device="cpu")
    assert (TS.expected_root_claim([9, 9], pubs[:2], device="cpu")
            == TS.join_claim(c1, c2)).all()
    # a long publics row (the keccak batch's length) through sponge_row
    long_pubs = rng.integers(0, 1 << 16, 18001, dtype=np.uint64)
    np.testing.assert_array_equal(
        TC.claim_digest(12, long_pubs, device="cpu"),
        JC.claim_digest(12, long_pubs))


# -- the join-tree scheduler (tests/test_recursion.py's cases) ------------


def _fake_prove(seg):
    return np.full(8, seg, dtype=np.uint32)


def test_scheduler_root_is_deterministic_fold():
    segs = [1, 2, 3, 4, 5]
    tree = aggregate_segments(segs, _fake_prove, max_workers=3)
    assert len(tree.seals) == 5
    c = [TSCH._leaf_claim(_fake_prove(s)) for s in segs]
    l1 = [TSCH.join_claims(c[0], c[1]), TSCH.join_claims(c[2], c[3]), c[4]]
    l2 = [TSCH.join_claims(l1[0], l1[1]), l1[2]]
    assert (tree.root_claim == TSCH.join_claims(l2[0], l2[1])).all()
    assert tree.depth == 3
    want = JSCH.aggregate_segments(segs, _fake_prove, max_workers=3)
    np.testing.assert_array_equal(tree.root_claim, want.root_claim)


def test_scheduler_retries_flaky_worker():
    failures = {2: 1}

    def flaky(seg):
        if failures.get(seg, 0) > 0:
            failures[seg] -= 1
            raise RuntimeError("transient")
        return _fake_prove(seg)

    tree = aggregate_segments([1, 2, 3], flaky, max_workers=2)
    assert tree.retries == 1
    ok = aggregate_segments([1, 2, 3], _fake_prove)
    assert (tree.root_claim == ok.root_claim).all()


def test_scheduler_gives_up_after_max_retries():
    def always_fail(seg):
        raise RuntimeError("dead")

    with pytest.raises(RuntimeError):
        aggregate_segments([1], always_fail, max_retries=1)


def test_scheduler_single_segment_tree():
    tree = aggregate_segments([9], _fake_prove)
    assert tree.depth == 0
    assert (tree.root_claim == TSCH._leaf_claim(_fake_prove(9))).all()


# -- one recursion proof on the CPU ---------------------------------------


def _tiny_program():
    """tests/test_recvm.py::test_prove_verify_roundtrip's program."""
    b = TB.Builder()
    x = b.input()
    y = b.input()
    s = b.add(x, y)
    d = b.sponge_hash([x, y, s])
    for j in range(8):
        b.bind_public(d[j], j)
    return b.build(), d


def test_tiny_recursion_proof_matches_fixture_and_verifies():
    fx = _fixture("recursion_tiny")
    pr, d = _tiny_program()
    assert pr.digest().hex() == fx["program_digest"]
    air = TVM.RecursionAir(pr)
    po2 = max(pr.po2(), fx["po2"])
    main, wom = air.witgen(np.array(fx["stream"], np.uint64), po2)
    pubs = [int(wom[c][0]) for c in d]
    seal = TPF.encode(TP.prove(air, main, pubs, device="cpu"))
    assert seal.shape[0] == fx["words"]
    assert _sha(seal) == fx["sha256"]
    TV.verify(air, TPF.decode(seal), pubs, device="cpu")
    # tamper: a different claimed public digest
    bad = list(pubs)
    bad[0] = (bad[0] + 1) % P
    with pytest.raises(TV.VerificationError):
        TV.verify(air, TPF.decode(seal), bad, device="cpu")
    # tamper: a forged WOM value with its LogUp recomputed
    forged = main.copy()
    frow = next(r for r in range(pr.n_rows) if pr.typ[r] == TVM.T_FMA
                and pr.mult[r][5] != 0)
    col = TVM.ML.VAL + 4 * 5
    forged[frow, col] = (forged[frow, col] + fx["forge_delta"]) % P
    with pytest.raises(TV.VerificationError):
        TV.verify(air, TP.prove(air, forged, pubs, device="cpu"), pubs,
                  device="cpu")


# -- end to end, live against the JAX package (ZETH_E2E=1) -----------------


@pytest.mark.skipif(not E2E, reason="slow e2e (set ZETH_E2E=1)")
def test_toy_lift_join_root_equal_reference_live():
    from zeth_tpu.zkp import verifier as JV
    air, proof1, pubs1 = _toy_proof()
    proof2 = _toy_proof(TOY_X0_2)[1]
    pubs2 = [int(p) for p in proof2.publics]
    rec = TS.aggregate(air, [proof1, proof2], device="cpu")
    TS.verify_root(rec, air, [TOY_PO2] * 2, [pubs1, pubs2], device="cpu")
    with pytest.raises(TV.VerificationError):
        TS.verify_root(rec, air, [TOY_PO2] * 2,
                       [[int(pubs1[0]) + 1, pubs1[1]], pubs2], device="cpu")
    jair = JSquareChainAir()
    jproofs = [JPF.decode(TPF.encode(p)) for p in (proof1, proof2)]
    jrec = JS.aggregate(jair, jproofs)
    np.testing.assert_array_equal(TPF.encode(rec.proof),
                                  JPF.encode(jrec.proof))
    JV.verify(jrec.node.air(), JPF.decode(TPF.encode(rec.proof)),
              [int(x) for x in rec.claim])



def _echo16_succinct_inner(monkeypatch):
    """The port's succinct receipt of echo_input(16) on the CPU, verified;
    returns (its inner receipt, the guest ELF)."""
    from zeth_tpu_torch import zkvm as TZ
    from zeth_tpu_torch.executor import compute_image_id
    monkeypatch.setenv("ZETH_SUCCINCT", "1")
    elf = guests.echo_input(16)
    env = TZ.ExecutorEnv.builder().write_slice(bytes(range(16))).build()
    info = TZ.LocalProver(device="cpu").prove(env, elf)
    assert info.receipt.inner.kind == "succinct"
    info.receipt.verify(compute_image_id(elf), device="cpu")
    return info.receipt.inner, elf


@pytest.mark.skipif(not E2E, reason="slow e2e (set ZETH_E2E=1)")
def test_succinct_receipt_equals_reference_live(monkeypatch):
    from zeth_tpu import zkvm as JZ
    inner, elf = _echo16_succinct_inner(monkeypatch)
    jenv = JZ.ExecutorEnv.builder().write_slice(bytes(range(16))).build()
    jinfo = JZ.LocalProver().prove(jenv, elf)
    np.testing.assert_array_equal(inner.root_seal,
                                  jinfo.receipt.inner.root_seal)


@pytest.mark.skipif(not E2E, reason="slow e2e (set ZETH_E2E=1; the port's "
                    "recursion proofs take ~35 min on 8 CPU cores)")
def test_succinct_receipt_equals_fixture(monkeypatch):
    """The port's root seal against the `succinct_echo16` digest, which
    the live check above found equal to the JAX package's: the next check
    needs no JAX run."""
    fx = _fixture("succinct_echo16")
    seal = _echo16_succinct_inner(monkeypatch)[0].root_seal
    assert (seal.shape[0], _sha(seal)) == (fx["words"], fx["sha256"])
