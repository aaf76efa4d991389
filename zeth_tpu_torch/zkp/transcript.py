"""Fiat-Shamir transcript: Poseidon2 duplex sponge (host, numpy).

Counterpart of ``zeth_tpu.zkp.transcript``: the host ``Transcript`` is a
jax-free copy; the proof-of-work search (``grind``) runs as a batched
torch search on the device it is given. It takes the FIRST hit in nonce
order, as the reference's ``_grind_batch_impl`` does (argmax), so both
provers pick the same nonce.

State: an 8-element "pool". mix(digest) folds a commitment in with one
permutation; sampling squeezes counter-indexed blocks so any number of
challenges can be drawn between commitments without extra mixing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..hostmath import P
from ..parallel import comm


class Transcript:
    def __init__(self, domain_tag: str = "zeth-tpu:proof:v1"):
        # pool <- hash of the domain tag bytes (as little-endian u32 field elems)
        raw = domain_tag.encode()
        raw += b"\x00" * (-len(raw) % 4)
        words = np.frombuffer(raw, dtype="<u4").astype(np.uint64) % np.uint64(P)
        self.pool = P2.hash_rows_np(words[None])[0]
        self._counter = 0
        self._buf: list[int] = []

    def mix(self, digest: np.ndarray) -> None:
        """Fold an 8-element digest into the pool; resets the squeeze state."""
        digest = np.asarray(digest, dtype=np.uint64)
        assert digest.shape == (P2.DIGEST_LEN,)
        self.pool = P2.hash_pairs_np(self.pool[None], digest[None])[0]
        self._counter = 0
        self._buf = []

    def mix_values(self, values: np.ndarray) -> None:
        """Mix a flat vector of field elements (hashed to a digest first).

        Long vectors hash as a 64-wide tree: chunk rows hash in one
        batched sponge call, their digests recurse. A flat absorb of k
        elements costs k/16 *sequential* host permutations; the tree
        costs O(log) batched calls — this is on both the prover's and
        verifier's critical path (tap mixing is ~2k elements).
        """
        flat = np.asarray(values, dtype=np.uint64).reshape(-1)
        while flat.shape[0] > 64:
            k = (flat.shape[0] + 63) // 64
            padded = np.zeros(k * 64, dtype=np.uint64)
            padded[:flat.shape[0]] = flat
            digests = P2.hash_rows_np(padded.reshape(k, 64))
            flat = digests.reshape(-1)
        self.mix(P2.hash_rows_np(flat[None])[0])

    def mix_u32_words(self, words: np.ndarray) -> None:
        """Mix raw u32 words (e.g. serialized journal bytes): split to 16-bit
        halves so every mixed value is a canonical field element."""
        w = np.asarray(words, dtype=np.uint64)
        halves = np.stack([w & 0xFFFF, w >> np.uint64(16)], axis=-1).reshape(-1)
        self.mix_values(halves)

    def _squeeze_block(self) -> None:
        state = np.zeros((P2.CELLS, 1), dtype=np.uint64)
        state[:P2.DIGEST_LEN, 0] = self.pool
        state[P2.DIGEST_LEN, 0] = self._counter
        out = P2.permute_np(state)[:, 0]
        self._counter += 1
        self._buf = [int(v) for v in out[:P2.RATE]]

    def sample(self) -> int:
        """One uniform base-field element."""
        if not self._buf:
            self._squeeze_block()
        return self._buf.pop(0)

    def sample_vec(self, k: int) -> np.ndarray:
        return np.array([self.sample() for _ in range(k)], dtype=np.uint64)

    def sample_ext(self) -> np.ndarray:
        """One extension element, shape (4,)."""
        return self.sample_vec(4)

    def sample_index(self, n: int) -> int:
        """Index in [0, n) for power-of-two n <= 2^27: one sample mod n.

        Since n | 2^27 and p = 15*2^27 + 1, ``v % n`` is uniform up to a
        single extra residue (bias exactly 1/p < 2^-30 per draw —
        cryptographically negligible). The rule is deliberately
        *straight-line* (one draw, no rejection loop) so the recursion
        circuit's in-circuit verifier can replay it with a fixed-shape
        program: decompose v into 31 bits (hi nibble = 15 forces the low
        27 bits to zero, making the decomposition unique below p) and
        take the low log2(n) bits.
        """
        assert n & (n - 1) == 0 and n <= (1 << 27)
        return self.sample() % n

    # -- proof-of-work grinding ---------------------------------------------
    #
    # The prover searches a nonce whose transcript-mix makes the next
    # sampled element end in `bits` zero bits; the verifier replays the
    # mix and checks. Sampled before the FRI query indices.

    def grind(self, bits: int, device=None, mesh=None) -> int:
        """Find, mix, and return a PoW nonce (batched search on `device`;
        None: the CUDA card; with a mesh the ranks search in turns)."""
        mask = (1 << bits) - 1
        nonce = grind_search(self.pool, bits, resolve_device(device, mesh),
                             mesh)
        self.mix_values(np.array([nonce], dtype=np.uint64))
        v = self.sample()
        assert v & mask == 0
        return nonce

    def check_grind(self, bits: int, nonce: int) -> bool:
        """Verifier side: replay the nonce mix; True iff the PoW holds."""
        self.mix_values(np.array([int(nonce)], dtype=np.uint64))
        return self.sample() & ((1 << bits) - 1) == 0


# -- device grind ---------------------------------------------------------------

GRIND_BATCH = 1 << 20       # nonces per device batch (the reference's batch)
GRIND_BATCH_CPU = 1 << 14   # a CPU searches in cache-sized batches


def grind_batch(pool_std: torch.Tensor, base: int, batch: int, bits: int):
    """Index of the first nonce in [base, base+batch) that passes, or -1.

    Emulates mix_values([nonce]) + the first squeeze block for every
    nonce at once, on standard-form int64 states. pool_std: (8,) int64.
    """
    dev = pool_std.device
    nonces = torch.arange(base, base + batch, dtype=torch.int64, device=dev)
    st = torch.zeros((P2.CELLS, batch), dtype=torch.int64, device=dev)
    st[0] = nonces
    digests = P2.permute_std(st)[:P2.DIGEST_LEN]           # hash_rows([n])
    st = torch.zeros_like(st)
    st[:P2.DIGEST_LEN] = pool_std[:, None]
    st[P2.DIGEST_LEN:2 * P2.DIGEST_LEN] = digests
    st[2 * P2.DIGEST_LEN] = P2.PAIR_TAG
    pools = P2.permute_std(st)[:P2.DIGEST_LEN]             # hash_pairs
    st = torch.zeros_like(st)
    st[:P2.DIGEST_LEN] = pools                             # counter 0
    first = P2.permute_std(st)[0]
    ok = (first & ((1 << bits) - 1)) == 0
    if not bool(ok.any()):
        return -1
    return int(torch.argmax(ok.to(torch.int8)))


def grind_search(pool, bits: int, device, mesh=None) -> int:
    """The smallest nonce whose mix passes the `bits` PoW check.

    With a mesh of D ranks, round k has rank d search batch k*D + d; the
    ranks' first hits of a round are gathered, and the lowest rank with
    a hit holds the smallest passing nonce (every lower nonce was
    searched in this round or an earlier one): the same nonce on every
    rank, and the same as the search alone."""
    batch = GRIND_BATCH if device.type == "cuda" else GRIND_BATCH_CPU
    pool_std = torch.tensor(np.asarray(pool, np.uint64).astype(np.int64),
                            device=device)
    d, r = (1, 0) if mesh is None else (comm.size(mesh), comm.rank(mesh))
    base = 0
    while True:
        assert base + d * batch <= P, "grind: nonce space exhausted"
        mine = base + r * batch
        hit = grind_batch(pool_std, mine, batch, bits)
        hit = mine + hit if hit >= 0 else -1
        if mesh is not None:
            hits = comm.all_gather(torch.tensor([hit], device=device), mesh)
            hit = next((int(h) for h in hits[:, 0].tolist() if h >= 0), -1)
        if hit >= 0:
            return hit
        base += d * batch
