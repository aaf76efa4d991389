"""Rank functions of tests/test_torch_parallel.py, run by
``zeth_tpu_torch.parallel.multihost.launch`` in spawned CPU processes.

This module imports no jax, so a rank starts in a few seconds; every
comparison with the JAX package runs in the test process on what the
ranks return. Inputs and results are numpy arrays (Montgomery uint32
views of the int32 tensors).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).copy()


def _block(a: np.ndarray, mesh) -> torch.Tensor:
    """This rank's contiguous row block of a global array."""
    from zeth_tpu_torch.parallel import comm
    m = a.shape[0] // comm.size(mesh)
    r = comm.rank(mesh)
    return _t(a[r * m:(r + 1) * m])


def _toy(name: str, fx: dict):
    from zeth_tpu_torch.circuits import toy as TT
    if name == "square_chain":
        return (TT.SquareChainAir(),
                *TT.SquareChainAir.witgen(fx["po2"], x0=fx["x0"]))
    return (TT.PermutationAir(),
            *TT.PermutationAir.witgen(fx["po2"], seed=fx["seed"]))


def transforms(mesh, inp: dict) -> dict:
    """This rank's blocks of the distributed transforms, the sharded root
    and openings, the shape rule's error, the halo'd tape evaluation of
    random LDEs, and the collectives' counts."""
    from zeth_tpu_torch import hostmath as H
    from zeth_tpu_torch.circuits.toy import PermutationAir
    from zeth_tpu_torch.hash import merkle
    from zeth_tpu_torch.parallel import (comm, dist_coset_lde, dist_intt,
                                         dist_ntt, sharded_commit_root)
    from zeth_tpu_torch.zkp import prover, tape
    out = {}
    x = _block(inp["x"], mesh)
    out["ntt"] = _np(dist_ntt(x, mesh))
    out["intt_ntt"] = _np(dist_intt(dist_ntt(x, mesh), mesh))
    out["lde"] = _np(dist_coset_lde(_block(inp["v"], mesh), mesh))
    m = _block(inp["m"], mesh)
    out["root"] = _np(sharded_commit_root(m, mesh))
    out["paths"] = np.stack(merkle.commit_rows_sharded(m, mesh)
                            .open_many(inp["queries"]))
    try:
        dist_ntt(_block(inp["small"], mesh), mesh)
    except ValueError as e:
        out["small"] = str(e)
    air = PermutationAir()
    prover.register_air(air)
    tp = prover._tape_program(air.name, 0)
    ldes = {g: _block(a, mesh) for g, a in inp["ldes"].items()}
    out["tape"] = _np(tape.eval_check(
        tp, ldes, [], inp["chal"], H.ext_powers(inp["alpha"], tp.n_stage),
        halo=prover._halo(tp, ldes, mesh)))
    out["stats"] = dict(comm.STATS)
    return out


def prove_toy(mesh, name: str, fx: dict) -> np.ndarray:
    """The toy AIR's seal, proved with prove(mesh=...)."""
    from zeth_tpu_torch.zkp import proof, prover
    air, main, pubs = _toy(name, fx)
    return proof.encode(prover.prove(air, main, pubs, device="cpu",
                                     mesh=mesh))


def prove_spin(mesh, seg, ia, iw) -> tuple:
    """(seal, paging seal) of prove_segments(mesh=...) on one segment."""
    from zeth_tpu_torch.circuits import rv32im
    (seal,), (pg_seal,) = rv32im.prove_segments([seg], ia, iw, device="cpu",
                                                mesh=mesh)
    return seal, pg_seal


def fails(mesh) -> None:
    """A rank that raises: rank 1 fails before the others' collective."""
    from zeth_tpu_torch.parallel import comm
    if comm.rank(mesh) == 1:
        raise ValueError("rank 1 fails on purpose")
    comm.all_gather(torch.zeros(1), mesh)
