"""Host Keccak-256 (numpy uint64 lanes).

Copy of the host half of ``zeth_tpu.hash.keccak``: ``permute_np`` and
``keccak256``, which the application layer (tries, transactions, headers)
hashes with. The batched device permutation of the JAX package is not
carried here.
"""

from __future__ import annotations

import numpy as np

# Public Keccak constants (FIPS 202).
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] and the pi permutation, flattened index = x + 5*y.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def permute_np(state64: np.ndarray) -> np.ndarray:
    """Ground truth Keccak-f[1600]. state64: (batch, 25) uint64."""
    s = state64.astype(np.uint64).copy()
    batch = s.shape[0]
    a = s.reshape(batch, 5, 5)  # a[:, y, x] = lane x + 5y

    def rotl(v, n):
        n %= 64
        if n == 0:
            return v
        return (v << np.uint64(n)) | (v >> np.uint64(64 - n))

    for rnd in range(24):
        c = a[:, 0, :].copy()
        for y in range(1, 5):
            c ^= a[:, y, :]
        d = np.empty_like(c)
        for x in range(5):
            d[:, x] = c[:, (x - 1) % 5] ^ rotl(c[:, (x + 1) % 5], 1)
        for y in range(5):
            a[:, y, :] ^= d
        b = np.empty_like(a)
        for x in range(5):
            for y in range(5):
                b[:, (2 * x + 3 * y) % 5, y] = rotl(a[:, y, x], _ROT[x][y])
        for x in range(5):
            for y in range(5):
                a[:, y, x] = b[:, y, x] ^ (~b[:, y, (x + 1) % 5] & b[:, y, (x + 2) % 5])
        a[:, 0, 0] ^= np.uint64(_RC[rnd])
    return a.reshape(batch, 25)


def keccak256(data: bytes) -> bytes:
    """Host keccak-256 (Ethereum's hash), built on permute_np. Rate 136B."""
    rate = 136
    msg = bytearray(data)
    msg.append(0x01)
    while len(msg) % rate != 0:
        msg.append(0x00)
    msg[-1] ^= 0x80
    state = np.zeros((1, 25), dtype=np.uint64)
    for off in range(0, len(msg), rate):
        block = np.frombuffer(bytes(msg[off:off + rate]), dtype="<u8")
        state[0, :rate // 8] ^= block
        state = permute_np(state)
    return state[0, :4].astype("<u8").tobytes()
