"""Merkle commitment trees over trace matrices (device build, host verify).

Counterpart of ``zeth_tpu.hash.merkle``. Leaves are committed in natural
row order; layer k holds 2^k digests, the root is layer 0, node i's
children are 2i and 2i+1. The leaf digests come from ``leaf_hash`` (the
CUDA kernel for a CUDA matrix), each level above them is hashed on the
device by ``hash_pairs`` in chunks of pairs, and levels of at most
``HOST_LEVELS_AT`` digests finish on the host in numpy. Queried-path opening gathers only
the needed digests; verification runs on the host. A matrix sharded in
row blocks over a mesh's ranks commits to a ``ShardedMerkleTree``
(``commit_rows_sharded``): each rank's subtree, and the top levels over
the gathered subtree roots on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import field as F
from .. import hostmath as H
from . import poseidon2 as P2


@dataclass
class MerkleTree:
    """layers[0] = root (1, 8) ... layers[-1] = leaves (n, 8), Montgomery.
    Device layers are int32 tensors; host-finished layers are numpy uint32."""
    layers: list
    n_leaves: int
    _root: np.ndarray = None

    @property
    def root(self) -> np.ndarray:
        """Root digest in standard form (host numpy uint64, shape (8,))."""
        if self._root is None:
            lay0 = self.layers[0]
            if isinstance(lay0, torch.Tensor):
                lay0 = lay0.cpu().numpy().view(np.uint32)
            self._root = H.from_monty_np(lay0[0])
        return self._root

    def open_many(self, indices: list) -> list:
        """Sibling paths (depth, 8) standard form for many leaves."""
        depth = len(self.layers) - 1
        sibs = _gather_paths(self.layers, _sibling_index_rows(indices, depth))
        return [np.stack([sibs[d][qi] for d in range(depth)])
                if depth else np.zeros((0, 8), np.uint64)
                for qi in range(len(indices))]


def _sibling_index_rows(indices, depth: int) -> list:
    """Bottom-up sibling index lists: row d indexes the d-th layer above
    the leaves."""
    rows, idxs = [], list(indices)
    for _ in range(depth):
        rows.append([i ^ 1 for i in idxs])
        idxs = [i >> 1 for i in idxs]
    return rows


def _gather_paths(layers, idx_rows) -> list:
    """Standard-form (n_queries, 8) sibling digests per level, bottom-up."""
    out = []
    for d, layer in enumerate(reversed(layers[1:])):
        idx = idx_rows[d]
        if isinstance(layer, torch.Tensor):
            sel = layer[torch.as_tensor(idx, device=layer.device)]
            sel = sel.cpu().numpy().view(np.uint32)
        else:
            sel = layer[np.asarray(idx, np.int64)]
        out.append(H.from_monty_np(sel))
    return out


def leaf_digests(matrix):
    """Leaf digests of a (rows, cols) Montgomery matrix: the CUDA leaf
    kernel for a CUDA tensor, the plain sponge for a CPU tensor."""
    return P2.leaf_hash(matrix.contiguous())


def commit_rows(matrix) -> MerkleTree:
    """Commit a (rows, cols) Montgomery matrix. rows must be a power of two."""
    n = matrix.shape[0]
    assert n & (n - 1) == 0, "row count must be a power of two"
    return commit_digests(leaf_digests(matrix))


def commit_digests(digests) -> MerkleTree:
    """Build a tree over precomputed leaf digests (n, 8) Montgomery."""
    n = digests.shape[0]
    assert n & (n - 1) == 0
    return MerkleTree(layers=_build_layers_from_digests(digests), n_leaves=n)


# At or below this many digests the remaining levels finish on the host:
# one small transfer replaces ~10 tiny device launches per tree.
HOST_LEVELS_AT = 1024


def _hash_level(cur):
    """The level above `cur` (2m, 8) -> (m, 8), in chunks of pairs: one
    ``hash_pairs`` call holds a (24, pairs) int64 state and the
    permutation's temporaries, so a whole level of 2^25 pairs (a po2=24
    LDE's tree) would need tens of GiB at once."""
    m = cur.shape[0] // 2
    pairs = F.CHUNK_ELEMS // 64
    out = torch.empty((m, cur.shape[1]), dtype=cur.dtype, device=cur.device)
    for i in range(0, m, pairs):
        blk = cur[2 * i:2 * (i + pairs)]
        out[i:i + blk.shape[0] // 2] = P2.hash_pairs(blk[0::2], blk[1::2])
    return out


def _build_layers_from_digests(digests) -> list:
    layers = [digests]
    cur = digests
    while cur.shape[0] > HOST_LEVELS_AT:
        cur = _hash_level(cur)
        layers.append(cur)
    if cur.shape[0] > 1:
        layers.extend(_host_levels(cur.cpu().numpy().view(np.uint32)))
    layers.reverse()
    return layers


def _host_levels(cur_m: np.ndarray) -> list:
    """Finish a tree on host. cur_m: (m, 8) uint32 Montgomery numpy.
    Returns the remaining levels (m/2, ..., 1) as Montgomery numpy."""
    std = H.from_monty_np(cur_m)
    out = []
    while std.shape[0] > 1:
        std = P2.hash_pairs_np(std[0::2], std[1::2])
        out.append(H.to_monty_np(std))
    return out


# ---------------------------------------------------------------------------
# Row-block-sharded trees (the multi-device path)
# ---------------------------------------------------------------------------


@dataclass
class ShardedMerkleTree:
    """The tree of a matrix whose rows are sharded in contiguous blocks
    over the D ranks of a mesh (D a power of two). Each rank keeps its
    block's subtree (``local``); every rank holds the top log2(D) levels
    (``top``: top[0] = root (1, 8), top[-1] = the D subtree roots (D, 8),
    Montgomery numpy), built from the gathered subtree roots. The root
    equals ``commit_rows`` of the whole matrix."""
    local: MerkleTree
    top: list
    mesh: object
    device: torch.device

    @property
    def root(self) -> np.ndarray:
        """Root digest in standard form (host numpy uint64, shape (8,))."""
        return H.from_monty_np(self.top[0][0])

    def open_many(self, indices: list) -> list:
        """Sibling paths (depth, 8) standard form for many global leaves,
        the same on every rank. The bottom of a path comes from the rank
        that owns the leaf: each rank reads the paths of the local
        indices in its subtree, the fixed-size (Q, depth, 8) results are
        gathered, and each query takes its owner's; the top log2(D)
        siblings come from the replicated top levels."""
        from ..parallel import comm
        m = self.local.n_leaves
        idx = np.asarray(indices, np.int64)
        owner = idx // m
        bottom = np.stack(self.local.open_many((idx % m).tolist())) \
            .astype(np.int64)                                 # (Q, dl, 8)
        got = comm.all_gather(torch.from_numpy(bottom).to(self.device),
                              self.mesh).cpu().numpy()
        bottom = got[owner, np.arange(idx.shape[0])].astype(np.uint64)
        top_std = [H.from_monty_np(lay) for lay in reversed(self.top[1:])]
        tops = np.stack([np.stack([lay[(s >> k) ^ 1]
                                   for k, lay in enumerate(top_std)])
                         if top_std else np.zeros((0, 8), np.uint64)
                         for s in owner.tolist()])
        return list(np.concatenate([bottom, tops], axis=1))


def commit_rows_sharded(matrix, mesh) -> ShardedMerkleTree:
    """Commit this rank's contiguous row block of a sharded matrix:
    its subtree by ``commit_rows`` (the leaf kernel on a card), the D
    subtree roots gathered and folded on every rank."""
    from ..parallel import comm
    d = comm.size(mesh)
    assert d & (d - 1) == 0, "the rank count must be a power of two"
    local = commit_rows(matrix)
    lay0 = local.layers[0]
    sub = lay0 if isinstance(lay0, torch.Tensor) else torch.from_numpy(
        np.asarray(lay0, np.uint32).view(np.int32))
    roots = comm.all_gather(sub[0].to(matrix.device), mesh)       # (D, 8)
    roots = roots.cpu().numpy().view(np.uint32)
    top = [roots] + _host_levels(roots)
    top.reverse()
    return ShardedMerkleTree(local=local, top=top, mesh=mesh,
                             device=matrix.device)


# ---------------------------------------------------------------------------
# Host-side verification (numpy, standard form)
# ---------------------------------------------------------------------------


def leaf_digest_np(row: np.ndarray) -> np.ndarray:
    """Hash one row of standard-form field elements to its leaf digest."""
    return P2.hash_rows_np(np.asarray(row, dtype=np.uint64)[None])[0]


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


def verify_path(root: np.ndarray, idx: int, row: np.ndarray,
                path: np.ndarray, depth: int, width: int) -> bool:
    """Check a row + sibling path against a root. All standard form.

    ``depth`` and ``width`` are the caller's expectations: a path of any
    other length or a row of any other width is rejected.
    """
    row = np.asarray(row)
    path = np.asarray(path)
    if row.ndim != 1 or row.shape[0] != width:
        return False
    if path.shape != (depth, P2.DIGEST_LEN):
        return False
    if not (0 <= idx < (1 << depth)):
        return False
    digest = leaf_digest_np(row)
    for sibling in path:
        if idx & 1:
            digest = P2.hash_pairs_np(sibling[None], digest[None])[0]
        else:
            digest = P2.hash_pairs_np(digest[None], sibling[None])[0]
        idx >>= 1
    return bool((digest == np.asarray(root, dtype=np.uint64)).all())
