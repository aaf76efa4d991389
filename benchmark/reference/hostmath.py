"""Frozen copy of ``zeth_tpu_torch/hostmath.py`` (Baby Bear and its
degree-4 extension on the host, numpy); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Field constants (python ints)
# ---------------------------------------------------------------------------

P = 2013265921                      # 15 * 2^27 + 1
TWO_ADICITY = 27
GENERATOR = 31                      # smallest generator of F_p^*
R = (1 << 32) % P                   # Montgomery R mod p == to_monty(1)
R2 = (R * R) % P                    # to_monty multiplier
RINV = pow(1 << 32, P - 2, P)       # 2^-32 mod p (from_monty multiplier)
NPRIME = ((1 << 32) - pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32
ROU_ORDER_27 = pow(GENERATOR, (P - 1) // (1 << 27), P)  # 0x1a427a41

# Forward/reverse roots of unity for every power of two up to 2^27.
ROU_FWD = [1] * (TWO_ADICITY + 1)
ROU_FWD[TWO_ADICITY] = ROU_ORDER_27
for _i in range(TWO_ADICITY - 1, -1, -1):
    ROU_FWD[_i] = (ROU_FWD[_i + 1] * ROU_FWD[_i + 1]) % P
ROU_REV = [pow(r, P - 2, P) for r in ROU_FWD]

BETA = 11                           # extension: x^4 - BETA irreducible
EXT_DEG = 4


def to_monty_np(a) -> np.ndarray:
    """Standard form -> Montgomery form, numpy uint32."""
    return ((np.asarray(a, np.uint64) << np.uint64(32))
            % np.uint64(P)).astype(np.uint32)


def from_monty_np(a) -> np.ndarray:
    """Montgomery form -> standard form, numpy uint64."""
    return np.asarray(a, np.uint64) * np.uint64(RINV) % np.uint64(P)

_U64 = np.uint64
PU = _U64(P)


def arr(x) -> np.ndarray:
    return np.asarray(x, dtype=_U64)


def fadd(a, b):
    return (arr(a) + arr(b)) % PU


def fsub(a, b):
    return (arr(a) + PU - arr(b) % PU) % PU


def fmul(a, b):
    return (arr(a) * arr(b)) % PU


def fneg(a):
    return (PU - arr(a) % PU) % PU


def fpow(a, e: int):
    a = arr(a)
    result = np.ones_like(a)
    e = int(e)
    while e:
        if e & 1:
            result = fmul(result, a)
        a = fmul(a, a)
        e >>= 1
    return result


def finv(a):
    return fpow(a, P - 2)


def fbatch_inv(a):
    """Montgomery batch inversion over the last axis (flat)."""
    a = arr(a)
    flat = a.reshape(-1)
    n = flat.shape[0]
    prefix = np.ones(n + 1, dtype=_U64)
    for i in range(n):
        prefix[i + 1] = (prefix[i] * flat[i]) % PU
    inv_all = int(finv(prefix[n]))
    out = np.zeros(n, dtype=_U64)
    acc = inv_all
    for i in range(n - 1, -1, -1):
        out[i] = (int(prefix[i]) * acc) % P
        acc = (acc * int(flat[i])) % P
    return out.reshape(a.shape)


# ---------------------------------------------------------------------------
# Degree-4 extension: shape (..., 4), x^4 = BETA
# ---------------------------------------------------------------------------

BETA_U = _U64(BETA)


def ext(x) -> np.ndarray:
    """Coerce int / base array / 4-list into an extension element (..., 4)."""
    a = np.asarray(x, dtype=_U64)
    if a.shape == () or a.shape[-1] != 4:
        base = a
        out = np.zeros(base.shape + (4,), dtype=_U64)
        out[..., 0] = base % PU
        return out
    return a % PU


def ext_add(a, b):
    return fadd(ext(a), ext(b))


def ext_sub(a, b):
    return fsub(ext(a), ext(b))


def ext_mul(a, b):
    a = ext(a)
    b = ext(b)
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    m = fmul
    c0 = fadd(m(a0, b0), fmul(BETA_U, fadd(fadd(m(a1, b3), m(a2, b2)), m(a3, b1))))
    c1 = fadd(fadd(m(a0, b1), m(a1, b0)), fmul(BETA_U, fadd(m(a2, b3), m(a3, b2))))
    c2 = fadd(fadd(m(a0, b2), m(a1, b1)), fadd(m(a2, b0), fmul(BETA_U, m(a3, b3))))
    c3 = fadd(fadd(m(a0, b3), m(a1, b2)), fadd(m(a2, b1), m(a3, b0)))
    return np.stack([c0, c1, c2, c3], axis=-1)


def ext_neg(a):
    return fneg(ext(a))


def ext_inv(a):
    a = ext(a)
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0 = fadd(fmul(a0, a0), fmul(BETA_U, fsub(fmul(a2, a2), fmul(fadd(a1, a1), a3))))
    b2 = fsub(fmul(fadd(a0, a0), a2), fadd(fmul(a1, a1), fmul(BETA_U, fmul(a3, a3))))
    dinv = finv(fsub(fmul(b0, b0), fmul(BETA_U, fmul(b2, b2))))
    n0 = fsub(fmul(a0, b0), fmul(BETA_U, fmul(a2, b2)))
    n1 = fsub(fmul(BETA_U, fmul(a3, b2)), fmul(a1, b0))
    n2 = fsub(fmul(a2, b0), fmul(a0, b2))
    n3 = fsub(fmul(a1, b2), fmul(a3, b0))
    return np.stack([n0, n1, n2, n3], axis=-1) * dinv[..., None] % PU


def ext_pow(a, e: int):
    a = ext(a)
    result = ext(np.ones(a.shape[:-1], dtype=_U64))
    e = int(e)
    while e:
        if e & 1:
            result = ext_mul(result, a)
        a = ext_mul(a, a)
        e >>= 1
    return result


def ext_is_zero(a) -> bool:
    return bool(np.all(ext(a) % PU == 0))


# ---------------------------------------------------------------------------
# Roots of unity / domains (standard form)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def rou_fwd(n: int) -> int:
    k = n.bit_length() - 1
    assert 1 << k == n and k <= TWO_ADICITY
    return ROU_FWD[k]


@functools.lru_cache(maxsize=None)
def rou_rev(n: int) -> int:
    k = n.bit_length() - 1
    assert 1 << k == n and k <= TWO_ADICITY
    return ROU_REV[k]


def powers(base: int, n: int) -> np.ndarray:
    """[1, base, base^2, ..., base^(n-1)] mod p (vectorized log-doubling:
    python per-element loops cost ~0.5 s/M on the prove path)."""
    out = np.ones(n, dtype=_U64)
    k, cur = 1, base % P
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = out[:m] * _U64(cur) % PU
        cur = cur * cur % P
        k *= 2
    return out


def ext_powers(base, n: int) -> np.ndarray:
    """Powers of an extension element: (n, 4)."""
    base = ext(base)
    out = np.empty((n, 4), dtype=_U64)
    acc = ext(1)
    for i in range(n):
        out[i] = acc
        acc = ext_mul(acc, base)
    return out


def ext_power_table(base, n: int) -> np.ndarray:
    """The same (n, 4) table as ``ext_powers``, by log-doubling: each step
    is one vectorized ext_mul instead of one per power. ``ext_powers``
    stays the reference's loop where the rv32im segment path calls it, so
    that path's host stage times stay comparable."""
    out = np.zeros((n, 4), dtype=_U64)
    if n == 0:
        return out
    out[0] = ext(1)
    k, cur = 1, ext(base)
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = ext_mul(out[:m], cur)
        cur = ext_mul(cur, cur)
        k *= 2
    return out


_RLC_BLOCK = 1 << 10


def ext_rlc(values, base) -> np.ndarray:
    """sum_i values[i] * base^(L-1-i) for L base-field values below 2^16
    and an extension element `base`: the Horner RLC of a limb stream, (4,).

    Equal to the loop ``acc += values[i] * ext_powers(base, L)[L-1-i]``,
    computed in bulk: the reversed stream is cut into blocks of 1,024
    values, each block's sum against [base^0 .. base^1023] is one exact
    uint64 product (each term < 2^47, a block's sum < 2^57), and the
    block sums are weighted by powers of base^1024. Field arithmetic is
    exact, so the order of the additions does not change the value."""
    v = np.asarray(values, dtype=_U64).reshape(-1)[::-1]
    n = v.shape[0]
    if n == 0:
        return np.zeros(4, dtype=_U64)
    if int(v.max()) >= 1 << 16:
        raise ValueError("ext_rlc takes values below 2^16")
    nblk = -(-n // _RLC_BLOCK)
    padded = np.zeros(nblk * _RLC_BLOCK, dtype=_U64)
    padded[:n] = v
    inner = (padded.reshape(nblk, _RLC_BLOCK)
             @ ext_power_table(base, _RLC_BLOCK)) % PU
    outer = ext_power_table(ext_pow(base, _RLC_BLOCK), nblk)
    return ext_mul(inner, outer).sum(axis=0) % PU
