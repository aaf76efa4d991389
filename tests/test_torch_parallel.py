"""The port's multi-device path against the JAX package's, on CPU ranks.

``zeth_tpu_torch.parallel`` runs one process per rank over
``torch.distributed`` (gloo on the CPU); ``zeth_tpu.parallel`` runs one
process over a ``Mesh`` of the virtual CPU devices that conftest.py
makes. The same numpy inputs (``default_rng`` seeds) go to both, at D=2
and D=4 ranks:

- ``dist_ntt``, ``dist_intt`` (round trip), ``dist_coset_lde`` and
  ``sharded_commit_root`` equal the JAX package's and the port's
  unsharded ``ntt``, ``_lde`` and ``merkle.commit_rows`` word for word,
  and the sharded tree's openings equal the unsharded tree's. The JAX
  package's outputs are held as SHA-256 digests (the ``mesh`` entry of
  tests/fixtures/torch_port_seals.json): on the CPU its shard_map
  programs compile for minutes (``sharded_commit_root`` ~4 min at D=2),
  so the live comparison runs with ZETH_E2E=1;
- the halo'd tape evaluation of each rank's LDE block equals the
  unsharded ``eval_check``;
- ``prove(mesh=...)`` on the toy AIRs at po2=6 gives the fixture seals
  (tests/test_torch_prover.py holds them equal to the JAX package's) on
  every rank, and the JAX verifier accepts them; at D=2,
  ``prove_segments(mesh=...)`` gives the spin fixture's seal and paging
  seal.

Each test spawns its ranks once (``multihost.launch`` of a function of
``torch_mesh_ranks``, which imports no jax) and checks everything they
return.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks
from zeth_tpu.circuits import toy as JT
from zeth_tpu.zkp import proof as JPF
from zeth_tpu.zkp import prover as JP
from zeth_tpu.zkp import tape as JTAPE
from zeth_tpu.zkp import verifier as JV
from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch import ntt as TN
from zeth_tpu_torch.circuits.toy import PermutationAir
from zeth_tpu_torch.hash import merkle as TM
from zeth_tpu_torch.hostmath import P
from zeth_tpu_torch.parallel import comm, multihost
from zeth_tpu_torch.zkp import prover as TP
from zeth_tpu_torch.zkp import tape as TTAPE

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")
E2E = os.environ.get("ZETH_E2E", "0") == "1"
RANKS = [2, 4]
TOYS = ["square_chain", "permutation"]


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


def _monty(rng, shape):
    return H.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))


def _seeded():
    """The fixture's inputs: x for dist_ntt / dist_intt, v for
    dist_coset_lde, m for the sharded commit (Montgomery uint32)."""
    mx = _fixture()["mesh"]
    return {k: _monty(np.random.default_rng(mx[k]["seed"]),
                      tuple(mx[k]["shape"])) for k in ("x", "v", "m")}


def _launch(fn, d, *args):
    return multihost.launch(fn, d, *args, device="cpu", threads=4 // d,
                            timeout=600)


def _cat(res, key):
    return np.concatenate([r[key] for r in res])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _sha(words) -> str:
    import hashlib
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


def _perm_tape_inputs(alpha):
    air = PermutationAir()
    TP.register_air(air)
    tp = TP._tape_program(air.name, 0)
    return tp, H.ext_powers(alpha, tp.n_stage)


@pytest.mark.parametrize("d", RANKS)
def test_sharded_transforms_equal_reference(d):
    """dist_ntt, dist_intt, dist_coset_lde and sharded_commit_root over d
    ranks: the JAX package's outputs (fixture digests) and the port's
    unsharded ones; the sharded tree's openings equal the unsharded
    tree's on every rank; the four-step's shape rule raises; the halo'd
    tape evaluation of each rank's block equals the unsharded one; every
    rank counted the same collectives."""
    rng = np.random.default_rng(31)
    inp = {**_seeded(),
           "queries": [0, 255] + rng.integers(0, 256, 10).tolist(),
           "small": _monty(rng, (d * d // 2, 1)),   # below the shape rule
           # random LDEs of the permutation AIR's groups (256 rows)
           "ldes": {g: _monty(rng, (256, c))
                    for g, c in (("control", 2), ("main", 2), ("aux", 1))},
           "chal": rng.integers(0, P, (1, 4), dtype=np.uint64),
           "alpha": rng.integers(0, P, 4, dtype=np.uint64)}
    res = _launch(torch_mesh_ranks.transforms, d, inp)
    mx = _fixture()["mesh"]
    got = _cat(res, "ntt")
    assert _sha(got) == mx["x"]["dist_ntt_sha256"]
    np.testing.assert_array_equal(
        got, TN.ntt(_t(inp["x"])).numpy().view(np.uint32))
    np.testing.assert_array_equal(_cat(res, "intt_ntt"), inp["x"])
    got = _cat(res, "lde")
    assert _sha(got) == mx["v"]["dist_coset_lde_sha256"]
    np.testing.assert_array_equal(
        got, TP._lde(_t(inp["v"]), std=False).numpy().view(np.uint32))
    tree = TM.commit_rows(_t(inp["m"]))
    paths = np.stack(tree.open_many(inp["queries"]))
    tp, alpha_pows = _perm_tape_inputs(inp["alpha"])
    tape_want = TTAPE.eval_check(
        tp, {g: _t(a) for g, a in inp["ldes"].items()}, [], inp["chal"],
        alpha_pows).numpy().view(np.uint32)
    np.testing.assert_array_equal(_cat(res, "tape"), tape_want)
    calls = {op: v[0] for op, v in res[0]["stats"].items()}
    assert set(calls) == {"all_to_all", "all_gather"}
    for r in res:                               # replicated on every rank
        assert _sha(r["root"]) == mx["m"]["sharded_commit_root_sha256"]
        np.testing.assert_array_equal(H.from_monty_np(r["root"]), tree.root)
        np.testing.assert_array_equal(r["paths"], paths)
        assert "n >= D^2" in r["small"]
        assert {op: v[0] for op, v in r["stats"].items()} == calls
        assert all(v[1] > 0 for v in r["stats"].values())


@pytest.mark.skipif(not E2E, reason="set ZETH_E2E=1 (the JAX package's "
                    "shard_map programs compile for minutes on the CPU)")
@pytest.mark.parametrize("d", RANKS)
def test_reference_parallel_equals_fixture_live(d):
    """zeth_tpu.parallel on Mesh(jax.devices()[:d]) gives the fixture's
    outputs (which the port's ranks are held to)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
    from zeth_tpu import parallel as JPAR
    mx, inp = _fixture()["mesh"], _seeded()
    mesh = Mesh(np.array(jax.devices()[:d]), ("rows",))

    def sh(a):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, PS("rows")))

    assert _sha(np.asarray(JPAR.dist_ntt(sh(inp["x"]), mesh))) == \
        mx["x"]["dist_ntt_sha256"]
    assert _sha(np.asarray(JPAR.dist_coset_lde(sh(inp["v"]), mesh))) == \
        mx["v"]["dist_coset_lde_sha256"]
    assert _sha(np.asarray(JPAR.sharded_commit_root(sh(inp["m"]), mesh))) \
        == mx["m"]["sharded_commit_root_sha256"]


def test_run_block_equals_reference():
    """The op-by-op interpreter against the JAX scan interpreter on the
    permutation AIR's tape: leaf matrices, one wrapping leaf block, the
    block's alpha-mix, and eval_check(single_block=True) against the
    level-scheduled evaluator."""
    rng = np.random.default_rng(7)
    ldes = {g: _monty(rng, (64, c))
            for g, c in (("control", 2), ("main", 2), ("aux", 1))}
    chal = rng.integers(0, P, (1, 4), dtype=np.uint64)
    tp, alpha_pows = _perm_tape_inputs(rng.integers(0, P, 4, np.uint64))
    jair = JT.PermutationAir()
    JP.register_air(jair)
    jtp = JP._tape_program(jair.name, 0)
    np.testing.assert_array_equal(np.asarray(jtp.ops), tp.ops)
    lj = {g: jnp.asarray(a) for g, a in ldes.items()}
    lt = {g: _t(a) for g, a in ldes.items()}
    np.testing.assert_array_equal(
        TTAPE.build_leafmat(tp.leaves, lt).numpy().view(np.uint32),
        np.asarray(JTAPE._build_leafmat(tuple(jtp.leaves), lj)))
    blk_t = TTAPE.build_leafblock(tp.leaves, lt, 48, 32)
    blk_j = JTAPE._build_leafblock(tuple(jtp.leaves), lj, 48, 32)
    np.testing.assert_array_equal(blk_t.numpy().view(np.uint32),
                                  np.asarray(blk_j))
    S = TTAPE.eval_scalars(tp, [], chal)
    W = H.to_monty_np(np.asarray(alpha_pows, np.uint64)[:tp.n_stage])
    pad = (-tp.n_stage) % JTAPE.REDUCE_CHUNK
    Wj = np.concatenate([W, np.zeros((pad, 4), np.uint32)])
    want = np.asarray(JTAPE._run_block(blk_j, jnp.asarray(jtp.ops),
                                       jnp.asarray(S), jnp.asarray(Wj),
                                       jtp.n_regs, jtp.n_stage))
    got = TTAPE.run_block(blk_t, tp, _t(S), _t(W))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    single = TTAPE.eval_check(tp, lt, [], chal, alpha_pows,
                              single_block=True).numpy().view(np.uint32)
    np.testing.assert_array_equal(single, np.asarray(JTAPE.eval_check(
        jtp, lj, [], chal, alpha_pows, single_block=True)))
    np.testing.assert_array_equal(single, TTAPE.eval_check(
        tp, lt, [], chal, alpha_pows).numpy().view(np.uint32))


@pytest.mark.parametrize("name", TOYS)
@pytest.mark.parametrize("d", RANKS)
def test_mesh_prove_seal_equals_fixture(d, name):
    """prove(mesh=...) over d ranks: the fixture seal on every rank, and
    the JAX verifier accepts it."""
    fx = _fixture()[name]
    seals = _launch(torch_mesh_ranks.prove_toy, d, name, fx)
    for seal in seals:
        assert seal.shape == (fx["words"],)
        assert _sha(seal) == fx["sha256"]
    if name == "square_chain":
        air, (_, pubs) = JT.SquareChainAir(), JT.SquareChainAir.witgen(
            fx["po2"], x0=fx["x0"])
    else:
        air, pubs = JT.PermutationAir(), []
    JV.verify(air, JPF.decode(seals[0]), pubs)


def test_mesh_prove_segments_spin_fixture():
    """prove_segments(mesh=...) over 2 ranks on the po2=11 spin fixture:
    its seal and paging seal (proved on rank 0 alone) on every rank."""
    from zeth_tpu_torch.executor import Executor, guests, load_image
    fx = _fixture()["spin"]
    elf = guests.spin(fx["spin_iters"])
    _, ia, iw = load_image(elf)
    seg = Executor(elf, segment_po2=fx["segment_po2"],
                   trace=True).run().segments[0]
    for seal, pg_seal in _launch(torch_mesh_ranks.prove_spin, 2, seg, ia,
                                 iw):
        assert (_sha(seal), _sha(pg_seal)) == (fx["seal_sha256"],
                                               fx["paging_sha256"])


def test_multihost_helpers_single_process():
    import torch.distributed as dist
    multihost.init()                # no-op without a rendezvous configured
    assert not dist.is_initialized()
    try:
        assert multihost.pod_mesh().size() >= 1
        assert multihost.local_mesh().size() >= 1
        assert multihost.shard_work([1, 2, 3]) == [1, 2, 3]
        assert comm.rank(multihost.pod_mesh()) == 0
    finally:
        dist.destroy_process_group()


def test_launch_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        multihost.launch(torch_mesh_ranks.fails, 2, device="cpu",
                         timeout=120)
