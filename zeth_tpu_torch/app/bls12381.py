"""BLS12-381 pairing (host-side, pure python ints).

Backs the EIP-4844 KZG point-evaluation precompile (0x0a) of the host
EVM engine (reference: revm's c-kzg/blst path, SURVEY.md §2.2
reth-stateless precompile stack; guests/stateless-client/Cargo.toml
blst patch). Structure mirrors the JAX package's app/bn254.py: the Fp2/Fp6/Fp12
tower with v^3 = XI and w^2 = v, affine Miller loop, final
exponentiation with a plain hard-part power.

Curve: y^2 = x^3 + 4 over Fp; the sextic twist is M-type
(y'^2 = x'^3 + 4*XI with XI = 1 + u), so the untwist divides by powers
of w — psi(x', y') = (x'/w^2, y'/w^3) — and the BLS parameter
x = -0xd201000000010000 is negative, handled by conjugating the Miller
value (p^6-power = inverse after final exponentiation since
p^6 = -1 mod r).
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = 0xD201000000010000      # |x|; the BLS parameter is -X_PARAM

# -- Fp2 = Fp[u]/(u^2 + 1) ----------------------------------------------------

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (1, 1)                       # the sextic non-residue 1 + u


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_mul(x, y):
    a = x[0] * y[0] % P
    b = x[1] * y[1] % P
    c = (x[0] + x[1]) * (y[0] + y[1]) % P
    return ((a - b) % P, (c - a - b) % P)


def f2_scalar(x, k):
    return (x[0] * k % P, x[1] * k % P)


def f2_neg(x):
    return ((-x[0]) % P, (-x[1]) % P)


def f2_conj(x):
    return (x[0], (-x[1]) % P)


def f2_inv(x):
    d = pow(x[0] * x[0] + x[1] * x[1], P - 2, P)
    return (x[0] * d % P, (-x[1]) * d % P)


def f2_pow(x, e):
    r = F2_ONE
    while e:
        if e & 1:
            r = f2_mul(r, x)
        x = f2_mul(x, x)
        e >>= 1
    return r


# -- Fp6 = Fp2[v]/(v^3 - XI) --------------------------------------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul(XI, f2_sub(
        f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)),
                       f2_add(t0, t1)), f2_mul(XI, t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)),
                       f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul_by_f2(x, k):
    return tuple(f2_mul(a, k) for a in x)


def f6_inv(x):
    a0, a1, a2 = x
    c0 = f2_sub(f2_mul(a0, a0), f2_mul(XI, f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul(XI, f2_mul(a2, a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_mul(a1, a1), f2_mul(a0, a2))
    t = f2_add(f2_mul(a0, c0),
               f2_mul(XI, f2_add(f2_mul(a2, c1), f2_mul(a1, c2))))
    ti = f2_inv(t)
    return (f2_mul(c0, ti), f2_mul(c1, ti), f2_mul(c2, ti))


# -- Fp12 = Fp6[w]/(w^2 - v) --------------------------------------------------

F12_ONE = (F6_ONE, F6_ZERO)


def _f6_mul_v(x):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = XI*a2 + a0 v + a1 v^2."""
    return (f2_mul(XI, x[2]), x[0], x[1])


def f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, _f6_mul_v(t1))
    c1 = f6_sub(f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1))
    return (c0, c1)


def f12_sq(x):
    return f12_mul(x, x)


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_inv(x):
    a0, a1 = x
    t = f6_sub(f6_mul(a0, a0), _f6_mul_v(f6_mul(a1, a1)))
    ti = f6_inv(t)
    return (f6_mul(a0, ti), f6_neg(f6_mul(a1, ti)))


def f12_pow(x, e):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, x)
        x = f12_sq(x)
        e >>= 1
    return r


# Frobenius (x^p) for the easy part of the final exponentiation.
_G1F = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def f6_frob(x):
    return (f2_conj(x[0]),
            f2_mul(f2_conj(x[1]), _G1F[2]),
            f2_mul(f2_conj(x[2]), _G1F[4]))


def f12_frob(x):
    c0 = f6_frob(x[0])
    y = x[1]
    c1 = (f2_mul(f2_conj(y[0]), _G1F[1]),
          f2_mul(f2_conj(y[1]), _G1F[3]),
          f2_mul(f2_conj(y[2]), _G1F[5]))
    return (c0, c1)


# -- curve points -------------------------------------------------------------
# G1: y^2 = x^3 + 4 over Fp; G2: y'^2 = x'^3 + 4*XI over Fp2.

B1 = 4
B2 = f2_scalar(XI, 4)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
G2_GEN = (
    (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
     0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
     0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


def g1_valid(pt):
    if pt is None:
        return True
    x, y = pt
    if x >= P or y >= P:
        return False
    return (y * y - x * x * x - B1) % P == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    if p1[0] == p2[0]:
        if (p1[1] + p2[1]) % P == 0:
            return None
        s = 3 * p1[0] * p1[0] * pow(2 * p1[1], P - 2, P) % P
    else:
        s = (p2[1] - p1[1]) * pow(p2[0] - p1[0], P - 2, P) % P
    x3 = (s * s - p1[0] - p2[0]) % P
    return (x3, (s * (p1[0] - x3) - p1[1]) % P)


def g1_mul(pt, k):
    r = None
    k %= R
    while k:
        if k & 1:
            r = g1_add(r, pt)
        pt = g1_add(pt, pt)
        k >>= 1
    return r


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_in_subgroup(pt) -> bool:
    """G1 has a nontrivial cofactor on this curve — decompressed points
    must be checked against the r-torsion."""
    if pt is None:
        return True
    r = None
    k = R
    q = pt
    while k:
        if k & 1:
            r = g1_add(r, q)
        q = g1_add(q, q)
        k >>= 1
    return r is None


def g2_valid(pt):
    if pt is None:
        return True
    x, y = pt
    if max(x[0], x[1], y[0], y[1]) >= P:
        return False
    return f2_mul(y, y) == f2_add(f2_mul(f2_mul(x, x), x), B2)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], f2_neg(pt[1]))


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    if p1[0] == p2[0]:
        if p1[1] != p2[1] or p1[1] == F2_ZERO:
            return None
        s = f2_mul(f2_scalar(f2_mul(p1[0], p1[0]), 3),
                   f2_inv(f2_scalar(p1[1], 2)))
    else:
        s = f2_mul(f2_sub(p2[1], p1[1]), f2_inv(f2_sub(p2[0], p1[0])))
    x3 = f2_sub(f2_sub(f2_mul(s, s), p1[0]), p2[0])
    return (x3, f2_sub(f2_mul(s, f2_sub(p1[0], x3)), p1[1]))


def g2_mul(pt, k):
    r = None
    k %= R
    while k:
        if k & 1:
            r = g2_add(r, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return r


def g2_in_subgroup(pt) -> bool:
    if pt is None:
        return True
    r = None
    k = R
    q = pt
    while k:
        if k & 1:
            r = g2_add(r, q)
        q = g2_add(q, q)
        k >>= 1
    return r is None


# -- ate pairing --------------------------------------------------------------


def _line(q1, q2, p):
    """Line through q1, q2 (G2 affine, twist coords) evaluated at p (G1
    affine), as an Fp12 element (scaled by the constant XI, which the
    final exponentiation kills).

    M-twist untwist psi(x', y') = (x'/w^2, y'/w^3) gives, for slope s'
    on the twist:  XI * l(P) = XI*py + [ (s' x'_1 - y'_1) v - s' px v^2 ] w.
    A vertical line (x - x_Q) untwists to XI*px - x'_1 v^2.
    """
    px, py = p
    if q1[0] == q2[0] and q1[1] == q2[1]:
        s = f2_mul(f2_scalar(f2_mul(q1[0], q1[0]), 3),
                   f2_inv(f2_scalar(q1[1], 2)))
    elif q1[0] == q2[0]:
        return ((f2_scalar(XI, px), F2_ZERO, f2_neg(q1[0])), F6_ZERO)
    else:
        s = f2_mul(f2_sub(q2[1], q1[1]), f2_inv(f2_sub(q2[0], q1[0])))
    a = f2_scalar(XI, py)
    b = f2_sub(f2_mul(s, q1[0]), q1[1])
    c = f2_scalar(s, (-px) % P)
    return ((a, F2_ZERO, F2_ZERO), (F2_ZERO, b, c))


def miller_loop(q, p):
    """f_{|x|,Q}(P), conjugated for the negative BLS parameter."""
    if q is None or p is None:
        return F12_ONE
    f = F12_ONE
    t = q
    for bit in bin(X_PARAM)[3:]:
        f = f12_mul(f12_sq(f), _line(t, t, p))
        t = g2_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line(t, q, p))
            t = g2_add(t, q)
    return f12_conj(f)        # x < 0: f^(p^6) = f^-1 after final exp


def final_exponentiation(f):
    f1 = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6 - 1)
    f2 = f12_mul(f12_frob(f12_frob(f1)), f1)       # ^(p^2 + 1)
    e = (P**4 - P**2 + 1) // R
    return f12_pow(f2, e)


def pairing(q, p):
    """e(P in G1, Q in G2) in Fp12."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1. Raises ValueError on invalid points."""
    f = F12_ONE
    for p1, q2 in pairs:
        if not g1_valid(p1):
            raise ValueError("bls12-381 g1 point not on curve")
        if not g2_valid(q2):
            raise ValueError("bls12-381 g2 point not on curve")
        if p1 is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(q2, p1))
    return final_exponentiation(f) == F12_ONE


# -- compressed-point decoding (the 48-byte EIP-4844 wire format) -------------


def sqrt_fp(a: int):
    """Square root in Fp (p = 3 mod 4), or None."""
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a % P else None


def g1_decompress(data: bytes):
    """48-byte compressed G1 point -> affine tuple / None (infinity).

    Raises ValueError on malformed encodings, off-curve x, or points
    outside the r-subgroup (the blst/c-kzg deserialize contract).
    """
    if len(data) != 48:
        raise ValueError("bad g1 length")
    flags = data[0] >> 5
    c_flag, i_flag, s_flag = (flags >> 2) & 1, (flags >> 1) & 1, flags & 1
    if not c_flag:
        raise ValueError("uncompressed g1 not accepted")
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if i_flag:
        if x != 0 or s_flag:
            raise ValueError("bad infinity encoding")
        return None
    if x >= P:
        raise ValueError("g1 x out of range")
    y = sqrt_fp((x * x * x + B1) % P)
    if y is None:
        raise ValueError("g1 x not on curve")
    # s_flag set = lexicographically larger root
    if (y > P - y) != bool(s_flag):
        y = P - y
    pt = (x, y)
    if not g1_in_subgroup(pt):
        raise ValueError("g1 point not in subgroup")
    return pt


# -- EIP-2537 precompile dispatch (Prague, addresses 0x0b..0x11) --------------
#
# Wire format per the EIP: Fp = 64 bytes (16 zero bytes || 48-byte BE),
# G1 = 128 bytes (x || y), G2 = 256 bytes (x_c0 || x_c1 || y_c0 || y_c1),
# infinity = all zeros. ADD accepts any on-curve point; MSM and PAIRING
# require subgroup membership. Backs the native engine's 0x0b-0x0f cases
# (app/csrc/evm.cpp) and the in-guest mirrors.


def _dec_fp(data: bytes) -> int:
    if len(data) != 64 or data[:16] != b"\x00" * 16:
        raise ValueError("bad fp padding")
    v = int.from_bytes(data[16:], "big")
    if v >= P:
        raise ValueError("fp out of range")
    return v


def _dec_g1(data: bytes, subgroup: bool):
    x = _dec_fp(data[:64])
    y = _dec_fp(data[64:])
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not g1_valid(pt):
        raise ValueError("g1 point not on curve")
    if subgroup and not g1_in_subgroup(pt):
        raise ValueError("g1 point not in subgroup")
    return pt


def _dec_g2(data: bytes, subgroup: bool):
    x = (_dec_fp(data[:64]), _dec_fp(data[64:128]))
    y = (_dec_fp(data[128:192]), _dec_fp(data[192:256]))
    if x == (0, 0) and y == (0, 0):
        return None
    pt = (x, y)
    if not g2_valid(pt):
        raise ValueError("g2 point not on curve")
    if subgroup and not g2_in_subgroup(pt):
        raise ValueError("g2 point not in subgroup")
    return pt


def _enc_fp(v: int) -> bytes:
    return v.to_bytes(64, "big")


def _enc_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * 128
    return _enc_fp(pt[0]) + _enc_fp(pt[1])


def _enc_g2(pt) -> bytes:
    if pt is None:
        return b"\x00" * 256
    (x, y) = pt
    return _enc_fp(x[0]) + _enc_fp(x[1]) + _enc_fp(y[0]) + _enc_fp(y[1])


def eip2537_dispatch(op: int, data: bytes) -> bytes:
    """op: 0=g1add 1=g1msm 2=g2add 3=g2msm 4=pairing (5/6 = map_fp*,
    unimplemented — the SSWU isogeny constants are not available in this
    build environment; the engine fails those blocks loudly).
    Raises ValueError on malformed input (precompile failure)."""
    if op == 0:
        if len(data) != 256:
            raise ValueError("g1add length")
        return _enc_g1(g1_add(_dec_g1(data[:128], False),
                              _dec_g1(data[128:], False)))
    if op == 1:
        if not data or len(data) % 160:
            raise ValueError("g1msm length")
        acc = None
        for off in range(0, len(data), 160):
            pt = _dec_g1(data[off:off + 128], True)
            k = int.from_bytes(data[off + 128:off + 160], "big")
            acc = g1_add(acc, g1_mul(pt, k))
        return _enc_g1(acc)
    if op == 2:
        if len(data) != 512:
            raise ValueError("g2add length")
        return _enc_g2(g2_add(_dec_g2(data[:256], False),
                              _dec_g2(data[256:], False)))
    if op == 3:
        if not data or len(data) % 288:
            raise ValueError("g2msm length")
        acc = None
        for off in range(0, len(data), 288):
            pt = _dec_g2(data[off:off + 256], True)
            k = int.from_bytes(data[off + 256:off + 288], "big")
            acc = g2_add(acc, g2_mul(pt, k))
        return _enc_g2(acc)
    if op == 4:
        if not data or len(data) % 384:
            raise ValueError("pairing length")
        pairs = []
        for off in range(0, len(data), 384):
            p1 = _dec_g1(data[off:off + 128], True)
            q2 = _dec_g2(data[off + 128:off + 384], True)
            if p1 is not None and q2 is not None:
                pairs.append((p1, q2))
        ok = pairing_check(pairs) if pairs else True
        return (1 if ok else 0).to_bytes(32, "big")
    raise NotImplementedError(f"eip2537 op {op}")
