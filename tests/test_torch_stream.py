"""The port's coset-streamed main group against its fixture seals and zeth_tpu.

With ``prover.STREAM_MAIN_BYTES`` set to 0 every main group that is not
pre-committed streams: its shifted coefficients stay resident and each
coset is recomputed where a stage needs it. The seals must hash to the
digests in tests/fixtures/torch_port_seals.json, which the resident path
gives and which equal the JAX package's seals: the toy AIRs at po2=6,
the po2=6 recursion proof, and the spin segment at po2=11 with its
paging proof (the rv32im aux group built on the device tensors, here CPU
tensors; the paging proof passes ``main_commit`` and stays resident).
The reference's verifier must accept the streamed toy proofs. The coset
helpers and the tape's stride-1 evaluation are held equal to zeth_tpu's
on seeded inputs, and each row- or column-chunked pass, with a tiny
chunk forced, to its one-chunk result.
"""

import functools
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeth_tpu.circuits import toy as JT
from zeth_tpu.zkp import proof as JPF
from zeth_tpu.zkp import prover as JP
from zeth_tpu.zkp import tape as JTAPE
from zeth_tpu.zkp import verifier as JV
from zeth_tpu_torch.circuits import rv32im as TRV
from zeth_tpu_torch import field as TF
from zeth_tpu_torch.circuits import toy as TT
from zeth_tpu_torch.executor import Executor, guests, load_image
from zeth_tpu_torch.hash import merkle as TM
from zeth_tpu_torch.hostmath import P
from zeth_tpu_torch.recursion import vm as TVM
from zeth_tpu_torch.zkp import proof as TPF
from zeth_tpu_torch.zkp import prover as TP
from zeth_tpu_torch.zkp import tape as TTAPE

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
CASES = ["square_chain", "permutation", "recursion_tiny", "spin"]


def _fixture(name):
    with open(FIXTURE) as f:
        return json.load(f)[name]


def _sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


def _tiny_recursion():
    """The recursion_tiny fixture's program (tests/test_recvm.py::
    test_prove_verify_roundtrip's), its witness and publics."""
    from zeth_tpu_torch.recursion import builder as TB
    fx = _fixture("recursion_tiny")
    b = TB.Builder()
    x = b.input()
    y = b.input()
    s = b.add(x, y)
    d = b.sponge_hash([x, y, s])
    for j in range(8):
        b.bind_public(d[j], j)
    pr = b.build()
    assert pr.digest().hex() == fx["program_digest"]
    air = TVM.RecursionAir(pr)
    main, wom = air.witgen(np.array(fx["stream"], np.uint64),
                           max(pr.po2(), fx["po2"]))
    return air, main, [int(wom[c][0]) for c in d]


def _toy(name):
    """(port air, reference air, main, publics) of a toy fixture."""
    fx = _fixture(name)
    if name == "square_chain":
        return (TT.SquareChainAir(), JT.SquareChainAir(),
                *TT.SquareChainAir.witgen(fx["po2"], x0=fx["x0"]))
    return (TT.PermutationAir(), JT.PermutationAir(),
            *TT.PermutationAir.witgen(fx["po2"], seed=fx["seed"]))


@functools.lru_cache(maxsize=None)
def _prove(name):
    """The case's seals (and, for the toys, the publics), proved on the
    CPU with every main group that is not pre-committed streamed."""
    assert TP.STREAM_MAIN_BYTES == 0
    if name == "spin":
        fx = _fixture("spin")
        elf = guests.spin(fx["spin_iters"])
        _, ia, iw = load_image(elf)
        res = Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
        return TRV.prove_segment(res.segments[0], ia, iw, device="cpu")
    if name == "recursion_tiny":
        air, main, pubs = _tiny_recursion()
    else:
        air, _, main, pubs = _toy(name)
    return TPF.encode(TP.prove(air, main, pubs, device="cpu")), pubs


@pytest.fixture(autouse=True)
def stream_every_main_group(monkeypatch):
    monkeypatch.setattr(TP, "STREAM_MAIN_BYTES", 0)


@pytest.mark.parametrize("name", CASES)
def test_streamed_seal_equals_fixture(name):
    fx = _fixture(name)
    if name == "spin":
        seal, pg_seal = _prove(name)
        assert TPF.decode(seal).po2 == fx["po2"]
        assert (_sha(seal), _sha(pg_seal)) == \
            (fx["seal_sha256"], fx["paging_sha256"])
    else:
        seal, _ = _prove(name)
        assert seal.shape == (fx["words"],)
        assert _sha(seal) == fx["sha256"]


@pytest.mark.parametrize("name", ["square_chain", "permutation"])
def test_reference_verifier_accepts_streamed_proof(name):
    seal, pubs = _prove(name)
    JV.verify(_toy(name)[1], JPF.decode(seal), pubs)


def test_stream_choice_follows_the_constant(monkeypatch):
    """The main group streams exactly when its LDE bytes exceed the
    constant and it was not pre-committed: the resident path computes no
    coset. Each prove is stopped at FRI (its grind is what costs here)."""
    air, _, main, pubs = _toy("square_chain")
    calls = []
    coset_eval = TP._coset_eval
    monkeypatch.setattr(TP, "_coset_eval",
                        lambda *a: calls.append(a[1]) or coset_eval(*a))

    class Stop(Exception):
        pass

    def stop(*a):
        raise Stop

    monkeypatch.setattr(TP.fri, "prove", stop)
    lde_bytes = TP.BLOWUP * main.shape[0] * air.main_cols * 4
    for limit, want in ((lde_bytes, []),
                        (lde_bytes - 1, [0, 1, 2, 3, 0, 1, 2, 3, 0])):
        # four cosets for the tree, four for the tape, coset 0 for the taps
        monkeypatch.setattr(TP, "STREAM_MAIN_BYTES", limit)
        calls.clear()
        with pytest.raises(Stop):
            TP.prove(air, main, pubs, device="cpu")
        assert calls == want
    calls.clear()
    handle = TP.commit_main(air, main, device="cpu")[1]
    with pytest.raises(Stop):
        TP.prove(air, main, pubs, main_commit=handle, device="cpu")
    assert calls == []


# -- the coset helpers and the tape's stride against zeth_tpu ----------------


def _rand(rng, shape):
    return rng.integers(0, P, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x
                      ).view(np.uint32)


def test_coset_helpers_equal_reference():
    n, c = 64, 5
    rng = np.random.default_rng(7)
    std = _rand(rng, (n, c))
    cf_t = TP._shifted_coeffs(_t(std))
    cf_j = JP._shifted_coeffs(jnp.asarray(std))
    np.testing.assert_array_equal(_np(cf_t), _np(cf_j))
    parts_t, parts_j = [], []
    for r in range(TP.BLOWUP):
        parts_t.append(TP._coset_eval(cf_t, r, n))
        parts_j.append(JP._coset_eval(cf_j, r, n))
        np.testing.assert_array_equal(_np(parts_t[-1]), _np(parts_j[-1]))
    full_t = TP._interleave4(parts_t)
    np.testing.assert_array_equal(_np(full_t), _np(JP._interleave4(
        tuple(parts_j))))
    # the interleaved cosets are the resident LDE, and a strided view of
    # it is each coset
    np.testing.assert_array_equal(_np(full_t), _np(TP._lde(_t(std), True)))
    for r in range(TP.BLOWUP):
        np.testing.assert_array_equal(_np(TP._coset_rows(full_t, r)),
                                      _np(parts_t[r]))


def test_tape_stride1_equals_reference():
    """tape.eval_check over one coset's rows (the control and aux groups
    as strided views of (4n, c) arrays) against zeth_tpu's, stride 1."""
    air_t, air_j, _, pubs = _toy("permutation")
    TP.register_air(air_t)
    JP.register_air(air_j)
    tp_t = TP._tape_program(air_t.name, len(pubs))
    tp_j = JP._tape_program(air_j.name, len(pubs))
    n = 64
    rng = np.random.default_rng(11)
    full = {"control": _rand(rng, (4 * n, air_t.control_cols)),
            "aux": _rand(rng, (4 * n, air_t.aux_cols))}
    main = _rand(rng, (n, air_t.main_cols))
    chal = rng.integers(0, P, (air_t.n_challenges, 4), dtype=np.uint64)
    alpha = rng.integers(0, P, (tp_t.n_stage, 4), dtype=np.uint64)
    r = 2
    got = TTAPE.eval_check(
        tp_t, {"main": _t(main), **{g: _t(a)[r::4] for g, a in full.items()}},
        pubs, chal, alpha, stride=1)
    want = JTAPE.eval_check(
        tp_j, {"main": jnp.asarray(main),
               **{g: jnp.asarray(a[r::4]) for g, a in full.items()}},
        pubs, chal, alpha, stride=1)
    assert got.shape == (n, 4)
    np.testing.assert_array_equal(_np(got), _np(want))


# -- chunked passes against their one-chunk results ---------------------------


@pytest.mark.parametrize("which", ["pair_levels", "point_inverses",
                                   "deep_f0", "column_chunks"])
def test_chunked_pass_equals_one_chunk(monkeypatch, which):
    rng = np.random.default_rng(3)
    m = 1 << 12
    if which == "pair_levels":
        args = (_t(_rand(rng, (m, 8))),)
        fn, tiny = TM._build_layers_from_digests, 64 * 64
    elif which == "point_inverses":
        args = (_t(_rand(rng, (m,))), _t(_rand(rng, (4,))))
        fn, tiny = TP._point_inverses, 100 * 64
    elif which == "deep_f0":
        args = (_t(_rand(rng, (m, 8))), *(_t(_rand(rng, (4,)))
                                          for _ in range(3)),
                _t(_rand(rng, (m, 4))), _t(_rand(rng, (m, 4))))
        fn, tiny = TP._deep_f0, 100 * 64
    else:
        args = (_t(_rand(rng, (m // 4, 7))),)
        fn, tiny = TP._extend_coset_evals, m

    def run():
        out = fn(*args)
        return [_np(x).copy() if isinstance(x, torch.Tensor) else x
                for x in (out if isinstance(out, list) else [out])]

    whole = run()
    monkeypatch.setattr(TF, "CHUNK_ELEMS", tiny)
    chunked = run()
    assert len(whole) == len(chunked)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a, b)
