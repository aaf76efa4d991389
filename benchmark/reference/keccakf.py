"""Keccak-f[1600] in numpy, written from FIPS 202, over a batch of states.

A state is 25 uint64 lanes, lane x + 5*y. ``RC`` is derived from the
standard's LFSR (rc(t)), not copied; ``PI_SRC`` / ``PI_ROT`` give the
rho+pi step as one gather (b[j] = rotl(a[PI_SRC[j]], PI_ROT[j])), the
form the keccak AIR's column layout is written in.
"""

from __future__ import annotations

import numpy as np

# rho offsets r[x][y] (FIPS 202, table 2)
ROT = [[0, 36, 3, 41, 18],
       [1, 44, 10, 45, 2],
       [62, 6, 43, 15, 61],
       [28, 55, 25, 21, 56],
       [27, 20, 39, 8, 14]]


def _rc_bit(t: int) -> int:
    """FIPS 202 algorithm 5, rc(t)."""
    if t % 255 == 0:
        return 1
    r = [1, 0, 0, 0, 0, 0, 0, 0]
    for _ in range(t % 255):
        r = [0] + r
        for i in (0, 4, 5, 6):
            r[i] ^= r[8]
        r = r[:8]
    return r[0]


RC = [sum(_rc_bit(j + 7 * i) << ((1 << j) - 1) for j in range(7))
      for i in range(24)]

PI_SRC = np.zeros(25, dtype=np.int32)
PI_ROT = np.zeros(25, dtype=np.int32)
for _x in range(5):
    for _y in range(5):
        PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
        PI_ROT[_y + 5 * ((2 * _x + 3 * _y) % 5)] = ROT[_x][_y]


def _rotl(a: np.ndarray, n) -> np.ndarray:
    n = np.asarray(n, np.uint64)
    return (a << n) | (a >> ((np.uint64(64) - n) % np.uint64(64)))


def permute(states: np.ndarray) -> np.ndarray:
    """Keccak-f[1600] of each row of an (n, 25) uint64 array."""
    a = np.array(states, dtype=np.uint64, copy=True)
    x = np.arange(5)
    for rnd in range(24):
        c = a.reshape(-1, 5, 5)                       # [n, y, x]
        cx = np.bitwise_xor.reduce(c, axis=1)         # C[x]
        d = cx[:, (x - 1) % 5] ^ _rotl(cx[:, (x + 1) % 5], 1)
        a = (c ^ d[:, None, :]).reshape(-1, 25)
        b = _rotl(a[:, PI_SRC], PI_ROT.astype(np.uint64))
        b3 = b.reshape(-1, 5, 5)
        a = (b3 ^ (~b3[:, :, (x + 1) % 5] & b3[:, :, (x + 2) % 5])) \
            .reshape(-1, 25)
        a[:, 0] ^= np.uint64(RC[rnd])
    return a
