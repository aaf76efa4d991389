"""Keccak-f[1600]: the batched torch permutation and the host Keccak-256.

Counterpart of ``zeth_tpu.hash.keccak``. The host half (``permute_np``,
``split_u64``/``join_u64``, ``keccak256``, and the rho+pi tables that the
keccak accelerator AIR imports) is a jax-free copy; ``permute`` is the
batched permutation on torch tensors, with each 64-bit lane held as a
(lo, hi) pair of 32-bit words as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

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


# rho+pi as one fused gather: b[j] = rotl(a[PI_SRC[j]], PI_ROT[j]) where the
# flat lane index is x + 5y and b[y + 5*((2x+3y)%5)] <- a[x + 5y] rot r[x][y].
_PI_SRC = np.zeros(25, dtype=np.int32)
_PI_ROT = np.zeros(25, dtype=np.int32)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        _PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _ROT[_x][_y]

_RC_PAIRS = np.array([[rc & 0xFFFFFFFF, rc >> 32] for rc in _RC], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def _rotl_pairs(lanes, n):
    """Rotate (..., 2) lane pairs (int64 holding uint32 words) left by
    per-lane amounts n (mod 64)."""
    n = n % 64
    lo, hi = lanes[..., 0], lanes[..., 1]
    swap = n >= 32
    m = n % 32
    l = torch.where(swap, hi, lo)
    h = torch.where(swap, lo, hi)
    inv = (32 - m) & 31  # guarded by the m==0 select below
    new_lo = torch.where(m == 0, l, ((l << m) & _M32) | (h >> inv))
    new_hi = torch.where(m == 0, h, ((h << m) & _M32) | (l >> inv))
    return torch.stack([new_lo, new_hi], dim=-1)


def permute(state):
    """Keccak-f[1600]. state: (batch, 25, 2) int32 holding uint32 words
    (lane = [lo, hi]) -> the same shape and dtype.

    The reference's round body: theta via a reshape xor-reduce, rho+pi as
    one gather with per-lane rotations, chi via rolls. The words are
    widened to int64 so that every shift is a logical one.
    """
    dev = state.device
    a = state.to(torch.int64) & _M32
    nb = a.shape[0]
    pi_src = torch.as_tensor(_PI_SRC.astype(np.int64), device=dev)
    pi_rot = torch.as_tensor(_PI_ROT.astype(np.int64), device=dev)[None, :]
    one = torch.ones((), dtype=torch.int64, device=dev)
    rcs = torch.as_tensor(_RC_PAIRS.astype(np.int64), device=dev)
    for rc in rcs:
        # theta: column parities over y (flat index x + 5y -> grid (y, x))
        grid = a.reshape(nb, 5, 5, 2)
        c = grid[:, 0] ^ grid[:, 1] ^ grid[:, 2] ^ grid[:, 3] ^ grid[:, 4]
        d = torch.roll(c, 1, dims=1) ^ _rotl_pairs(torch.roll(c, -1, dims=1),
                                                   one)
        a = (grid ^ d[:, None]).reshape(nb, 25, 2)
        # rho + pi
        b = _rotl_pairs(a[:, pi_src], pi_rot)
        # chi on grid (y, x)
        bg = b.reshape(nb, 5, 5, 2)
        ag = bg ^ ((~torch.roll(bg, -1, dims=2)) & torch.roll(bg, -2, dims=2))
        a = ag.reshape(nb, 25, 2).clone()
        # iota
        a[:, 0] ^= rc
    return torch.where(a >= 1 << 31, a - (1 << 32), a).to(torch.int32)


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


def split_u64(state64: np.ndarray) -> np.ndarray:
    """(batch, 25) uint64 -> (batch, 25, 2) uint32 [lo, hi]."""
    lo = (state64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (state64 >> np.uint64(32)).astype(np.uint32)
    return np.stack([lo, hi], axis=-1)


def join_u64(state32: np.ndarray) -> np.ndarray:
    s = np.asarray(state32, dtype=np.uint64)
    return s[..., 0] | (s[..., 1] << np.uint64(32))


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
