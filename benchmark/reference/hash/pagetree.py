"""Frozen copy of ``zeth_tpu_torch/hash/pagetree.py`` (the Poseidon2
page tree of a memory image, numpy); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from . import poseidon2 as P2

PAGE_BITS = 10
PAGE_WORDS = 1 << (PAGE_BITS - 2)      # 256 words per page
PAGE_LIMBS = 2 * PAGE_WORDS            # 512 16-bit limbs
DEPTH = 32 - PAGE_BITS                 # 22 tree levels
N_PAGES = 1 << DEPTH

LEAF_TAG = 1
NODE_TAG = 2


def page_digests_np(pages: np.ndarray) -> np.ndarray:
    """(k, 256) uint words -> (k, 8) leaf digests (standard form)."""
    pages = np.asarray(pages, dtype=np.uint64)
    k = pages.shape[0]
    assert pages.shape == (k, PAGE_WORDS)
    limbs = np.empty((k, PAGE_LIMBS), dtype=np.uint64)
    limbs[:, 0::2] = pages & np.uint64(0xFFFF)
    limbs[:, 1::2] = pages >> np.uint64(16)
    state = np.zeros((P2.CELLS, k), dtype=np.uint64)
    state[P2.RATE] = LEAF_TAG
    for off in range(0, PAGE_LIMBS, P2.RATE):
        state[:P2.RATE] = (state[:P2.RATE] + limbs[:, off:off + P2.RATE].T) \
            % H.PU
        state = P2.permute_np(state)
    return state[:8].T.copy()


def node_digests_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """(k, 8) x (k, 8) -> (k, 8) parent digests."""
    left = np.asarray(left, dtype=np.uint64)
    right = np.asarray(right, dtype=np.uint64)
    k = left.shape[0]
    state = np.zeros((P2.CELLS, k), dtype=np.uint64)
    state[:8] = left.T
    state[8:16] = right.T
    state[P2.RATE] = NODE_TAG
    state = P2.permute_np(state)
    return state[:8].T.copy()


def _zero_digests() -> list[np.ndarray]:
    """Z[k] = digest of a depth-k all-zero subtree; Z[0] = zero-page leaf."""
    z = [page_digests_np(np.zeros((1, PAGE_WORDS), dtype=np.uint64))[0]]
    for _ in range(DEPTH):
        z.append(node_digests_np(z[-1][None], z[-1][None])[0])
    return z


_ZCACHE: list[np.ndarray] | None = None


def zero_digests() -> list[np.ndarray]:
    global _ZCACHE
    if _ZCACHE is None:
        _ZCACHE = _zero_digests()
    return _ZCACHE


class SparsePageTree:
    """Sparse page tree over the 2^32 byte space (zero-page defaults).

    Tracks only touched pages; digests are (re)computed lazily per
    query batch. Words are byte-addressed through ``get_word``/
    ``set_word`` (word-aligned addresses).
    """

    def __init__(self, image_addrs=None, image_words=None):
        self.pages: dict[int, np.ndarray] = {}
        if image_addrs is not None:
            a = np.asarray(image_addrs, dtype=np.uint64)
            w = np.asarray(image_words, dtype=np.uint64)
            for addr, word in zip(a, w):
                self.set_word(int(addr), int(word))

    def _page(self, pnum: int) -> np.ndarray:
        p = self.pages.get(pnum)
        if p is None:
            p = np.zeros(PAGE_WORDS, dtype=np.uint64)
            self.pages[pnum] = p
        return p

    def get_word(self, addr: int) -> int:
        pnum = (addr >> PAGE_BITS) & (N_PAGES - 1)
        p = self.pages.get(pnum)
        if p is None:
            return 0
        return int(p[(addr >> 2) & (PAGE_WORDS - 1)])

    def set_word(self, addr: int, word: int) -> None:
        self._page((addr >> PAGE_BITS) & (N_PAGES - 1))[
            (addr >> 2) & (PAGE_WORDS - 1)] = word & 0xFFFFFFFF

    def page_words(self, pnum: int) -> np.ndarray:
        """(256,) copy of a page's words (zeros if untouched)."""
        p = self.pages.get(pnum)
        return (p.copy() if p is not None
                else np.zeros(PAGE_WORDS, dtype=np.uint64))

    # -- digests -----------------------------------------------------------

    def _levels(self) -> list[dict[int, np.ndarray]]:
        """Sparse digest maps per level (0 = leaves), touched nodes only."""
        z = zero_digests()
        pnums = sorted(self.pages)
        levels: list[dict[int, np.ndarray]] = []
        if pnums:
            digs = page_digests_np(
                np.stack([self.pages[p] for p in pnums]))
            cur = {p: digs[i] for i, p in enumerate(pnums)}
        else:
            cur = {}
        levels.append(cur)
        for k in range(DEPTH):
            parents = sorted({i >> 1 for i in cur})
            if parents:
                lefts = np.stack([cur.get(2 * i, z[k]) for i in parents])
                rights = np.stack(
                    [cur.get(2 * i + 1, z[k]) for i in parents])
                digs = node_digests_np(lefts, rights)
                cur = {i: digs[j] for j, i in enumerate(parents)}
            else:
                cur = {}
            levels.append(cur)
        return levels

    def root(self) -> np.ndarray:
        """(8,) root digest."""
        levels = self._levels()
        return levels[DEPTH].get(0, zero_digests()[DEPTH]).copy()

    def paths(self, pnums: list[int]) -> tuple[np.ndarray, np.ndarray]:
        """Sibling paths for a batch of pages.

        Returns (root (8,), sibs (len(pnums), DEPTH, 8)): sibs[i][k] is
        the sibling digest at level k on page pnums[i]'s path.
        """
        levels = self._levels()
        z = zero_digests()
        sibs = np.empty((len(pnums), DEPTH, 8), dtype=np.uint64)
        for i, pnum in enumerate(pnums):
            idx = int(pnum)
            for k in range(DEPTH):
                sibs[i, k] = levels[k].get(idx ^ 1, z[k])
                idx >>= 1
        return levels[DEPTH].get(0, z[DEPTH]).copy(), sibs
