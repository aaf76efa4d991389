"""The SHA-256 compression function, written from FIPS 180-4.

The round constants are worked out from the primes (the first 32 bits of
the fractional parts of their cube roots), not copied.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF


def _primes(n: int) -> list:
    out, k = [], 2
    while len(out) < n:
        if all(k % p for p in out if p * p <= k):
            out.append(k)
        k += 1
    return out


def _icbrt(v: int) -> int:
    """floor(v ** (1/3)) for a non-negative integer."""
    lo, hi = 0, 1 << (v.bit_length() // 3 + 2)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid ** 3 <= v:
            lo = mid
        else:
            hi = mid - 1
    return lo


K = [_icbrt(p << 96) & M32 for p in _primes(64)]


def compress(state: list, block: list) -> list:
    """The next 8-word state after one 16-word block (feed-forward
    included)."""
    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M32
    w = list(block)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        t1 = (h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25))
              + ((e & f) ^ (~e & g & M32)) + K[t] + w[t]) & M32
        t2 = ((rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22))
              + ((a & b) ^ (a & c) ^ (b & c))) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, \
            (t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip(state, (a, b, c, d, e, f, g, h))]
