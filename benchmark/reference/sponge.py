"""The Poseidon2 sponge of a few long rows, lean numpy.

``hash_rows_np`` pays numpy's per-call cost some two thousand times a
permutation, which for the 51,200 permutations of one keccak batch's
claims row is minutes. Here a permutation is some four hundred numpy
calls on a (24, rows) state, whatever the number of rows, so the claims
rows of every batch of a run hash together in about the time of one.
The same permutation as ``poseidon2.permute_np`` (its round constants and
internal diagonal; M_E as one 24x24 matrix) and the same sponge (rate
16, add-into-rate absorb, a ragged last chunk zero-padded, digest = the
first 8 cells).
"""

from __future__ import annotations

import functools

import numpy as np

from .hash import poseidon2 as P2
from .hostmath import P

PU = np.uint64(P)


@functools.lru_cache(maxsize=1)
def _tables() -> tuple:
    c = P2.constants()
    m4 = P2._M4.astype(np.uint64)
    me = np.tile(m4, (6, 6))                  # circ(2*M4, M4, ..., M4)
    me += np.kron(np.eye(6, dtype=np.uint64), m4)
    return (me, c["rc_ext"].astype(np.uint64)[:, :, None],
            [np.uint64(v) for v in c["rc_int"]],
            ((c["diag"].astype(np.uint64) + PU - np.uint64(1)) % PU)[:, None])


def _x7(v: np.ndarray) -> np.ndarray:
    v2 = v * v % PU
    return v2 * v2 % PU * v2 % PU * v % PU


def permute(x: np.ndarray) -> np.ndarray:
    """Poseidon2 on a (24, rows) uint64 standard-form state. Every
    product is of two values below p < 2^31, every M_E sum below 2^40."""
    me, rc_ext, rc_int, dm1 = _tables()
    x = me @ x % PU
    for r in range(8):
        if r == 4:
            for rc in rc_int:
                x[0] = _x7((x[0] + rc) % PU)
                x = (x * dm1 + x.sum(axis=0)) % PU
        x = me @ _x7((x + rc_ext[r]) % PU) % PU
    return x


def sponge(rows: np.ndarray) -> np.ndarray:
    """(rows, 8) digests of a (rows, k) array of standard-form values."""
    rows = np.asarray(rows, np.uint64) % PU
    state = np.zeros((24, rows.shape[0]), np.uint64)
    for off in range(0, max(rows.shape[1], 1), 16):
        chunk = rows[:, off:off + 16].T
        state[:chunk.shape[0]] = (state[:chunk.shape[0]] + chunk) % PU
        state = permute(state)
    return state[:8].T.copy()
