"""Frozen copy of ``zeth_tpu_torch/zkp/prover.py`` (the proof's data types,
the tap order, the challenges, and the control group's LDE in plain torch); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import field as F
from .. import ntt
from ..hash import merkle
from ..hostmath import GENERATOR
from . import fri
from .air import Air


BLOWUP = fri.BLOWUP


# Tap stream order (PROTOCOL.md step 5): offset 0 = z, offset 1 = z*w_n.
TAP_STREAMS = [("control", 0), ("main", 0), ("aux", 0), ("check", 0),
               ("control", 1), ("main", 1), ("aux", 1)]


@dataclass
class GroupOpening:
    rows: np.ndarray     # (n_queries, cols) standard form LDE rows
    paths: list          # n_queries sibling paths (depth, 8)


@dataclass
class StarkProof:
    air_name: str
    po2: int
    publics: list
    roots: dict          # group -> (8,) digest
    taps: np.ndarray     # (n_taps, 4) standard form, TAP_STREAMS order
    fri_proof: fri.FriProof
    openings: dict       # group -> GroupOpening
    query_indices: list


def _upload_std(a_std: np.ndarray, device) -> torch.Tensor:
    """(n, c) standard-form host matrix -> standard-form int32 tensor."""
    a32 = np.ascontiguousarray(np.asarray(a_std, np.uint64).astype(np.uint32))
    return torch.from_numpy(a32.view(np.int32)).to(device)


def scalar_publics(air: Air, publics):
    """The leading publics that enter constraints as scalars."""
    n_ps = getattr(air, "n_public_scalars", None)
    return publics if n_ps is None else publics[:n_ps]


def all_challenges(air: Air, publics, sampled: np.ndarray,
                   derived_extra=None) -> np.ndarray:
    """Sampled challenges + the AIR's derived challenge-like scalars.

    derived_extra may be a callable taking the sampled challenges (the
    prover computes companion-bound values like d0/d1 only once the
    shared challenges exist) or a plain dict (the verifier passes the
    companion proof's public values)."""
    if not getattr(air, "n_derived", 0):
        return sampled
    if callable(derived_extra):
        derived_extra = derived_extra(sampled)
    derived = np.asarray(
        air.derived_challenges(publics, sampled, extra=derived_extra),
        np.uint64).reshape(-1, 4)
    return np.concatenate([sampled.reshape(-1, 4), derived], axis=0)


# -- LDE --------------------------------------------------------------------------


def _lde_group(trace_monty):
    """(n, c) trace -> (coeffs (n, c), lde (4n, c)) on the coset 31*<w_4n>."""
    n, c = trace_monty.shape
    coeffs = ntt.intt(trace_monty)
    scaled = F.mul_std(coeffs, ntt.power_table(GENERATOR, n,
                                               trace_monty.device)[:, None])
    padded = torch.zeros((BLOWUP * n, c), dtype=torch.int32,
                         device=trace_monty.device)
    padded[:n] = scaled
    return coeffs, ntt.ntt(padded)


def _by_columns(fn, x, rows_out: int):
    """fn over column chunks of x, each result (rows_out, w) int32 holding
    about F.CHUNK_ELEMS elements, written into one (rows_out, c) tensor."""
    c = x.shape[1]
    out = torch.empty((rows_out, c), dtype=torch.int32, device=x.device)
    w = max(1, F.CHUNK_ELEMS // rows_out)
    for off in range(0, c, w):
        out[:, off:off + w] = fn(x[:, off:off + w])
    return out


def _lde(dev):
    """Column-chunked LDE of an (n, c) standard-form tensor into a (4n, c)
    Montgomery tensor (the prover's ``_lde`` with ``std=True``, one
    device)."""
    return _by_columns(lambda ch: _lde_group(F.to_monty(ch))[1], dev,
                       BLOWUP * dev.shape[0])


def control_root(control_std: np.ndarray, device) -> np.ndarray:
    """The Merkle root of a control trace's LDE, committed as the prover
    commits it: the (8,) standard-form digest."""
    lde = _lde(_upload_std(control_std, device))
    return merkle.root_of_rows(lde)
