"""Frozen copy of ``zeth_tpu_torch/hash/merkle.py`` (the host verification of
Merkle paths, and a tree's root in plain torch); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostmath as H
from . import poseidon2 as P2


# ---------------------------------------------------------------------------
# Host-side verification (numpy, standard form)
# ---------------------------------------------------------------------------


def verify_many(root: np.ndarray, idxs, rows, paths, depth: int,
                width: int) -> bool:
    """Batched verify_path: all queries hash level-by-level together."""
    rows = np.asarray(rows, dtype=np.uint64)
    q = rows.shape[0]
    if rows.shape != (q, width) or len(paths) != q or len(idxs) != q:
        return False
    pm = np.zeros((q, depth, P2.DIGEST_LEN), dtype=np.uint64)
    for i, p in enumerate(paths):
        p = np.asarray(p)
        if p.shape != (depth, P2.DIGEST_LEN):
            return False
        pm[i] = p
    idx = np.asarray(idxs, dtype=np.int64)
    if ((idx < 0) | (idx >= (1 << depth))).any():
        return False
    digest = P2.hash_rows_np(rows)
    for d in range(depth):
        sib = pm[:, d]
        odd = (idx & 1) == 1
        left = np.where(odd[:, None], sib, digest)
        right = np.where(odd[:, None], digest, sib)
        digest = P2.hash_pairs_np(left, right)
        idx >>= 1
    return bool((digest == np.asarray(root, dtype=np.uint64)[None]).all())


def root_of_rows(matrix) -> np.ndarray:
    """The root of the Merkle tree over the rows of a (rows, cols)
    Montgomery int32 tensor, rows a power of two: each leaf the plain
    sponge of its row, each node ``hash_pairs`` of its children, as
    ``commit_rows`` builds it. Returns the (8,) standard-form digest."""
    n = matrix.shape[0]
    assert n & (n - 1) == 0, "row count must be a power of two"
    cur = P2.hash_rows(matrix.contiguous())
    while cur.shape[0] > 1:
        cur = P2.hash_pairs(cur[0::2], cur[1::2])
    return H.from_monty_np(cur.cpu().numpy().view(np.uint32))[0]
