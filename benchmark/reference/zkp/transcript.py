"""Frozen copy of ``zeth_tpu_torch/zkp/transcript.py`` (the host Fiat-Shamir
transcript, without the prover's nonce search); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from ..hash import poseidon2 as P2
from ..hostmath import P


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

    def check_grind(self, bits: int, nonce: int) -> bool:
        """Verifier side: replay the nonce mix; True iff the PoW holds."""
        self.mix_values(np.array([int(nonce)], dtype=np.uint64))
        return self.sample() & ((1 << bits) - 1) == 0


# -- device grind ---------------------------------------------------------------
