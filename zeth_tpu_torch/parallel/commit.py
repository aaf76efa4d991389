"""Sharded Merkle commitment: local subtrees + an all_gather of their roots.

Counterpart of ``zeth_tpu.parallel.commit``. Each rank hashes its
contiguous block of LDE rows into a subtree (the CUDA leaf kernel on a
card, the plain ``hash_rows`` on the CPU), the D subtree roots are
gathered, and every rank folds them into the global root. For a power of
two D the root equals ``merkle.commit_rows`` of the whole matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hash import merkle


def sharded_commit_root(matrix, mesh):
    """Global Merkle root of a row-block-sharded (n/D, cols) Montgomery
    matrix: the replicated (8,) Montgomery digest, an int32 tensor on the
    matrix's device."""
    tree = merkle.commit_rows_sharded(matrix, mesh)
    return torch.from_numpy(
        np.ascontiguousarray(tree.top[0][0]).view(np.int32)).to(matrix.device)
