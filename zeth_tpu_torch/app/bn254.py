"""alt_bn128 (BN254) optimal ate pairing, pure Python.

Backs the EVM pairing-check precompile (0x08) and the Groth16 verifier
(zeth_tpu_torch.zkp.groth16) — the reference gets these from substrate-bn /
arkworks (SURVEY.md §2.2 guest crypto patches, risc0-groth16). Python
big-int arithmetic is well-suited here: 256-bit mulmod is a native
bignum op, so a pairing costs ~0.1-0.5 s — fine for block validation
(gas bounds the pair count) and receipt verification.

Tower: Fp2 = Fp[u]/(u^2+1); Fp6 = Fp2[v]/(v^3 - (9+u)); Fp12 =
Fp6[w]/(w^2 - v). All Frobenius coefficients are derived at import.
"""

from __future__ import annotations

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN_X = 4965661367192848881           # BN curve parameter
ATE_LOOP = 6 * BN_X + 2

# Fp2 elements are (a, b) = a + b*u


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_mul(x, y):
    a = x[0] * y[0] % P
    b = x[1] * y[1] % P
    return ((a - b) % P, ((x[0] + x[1]) * (y[0] + y[1]) - a - b) % P)


def f2_scalar(x, k):
    return (x[0] * k % P, x[1] * k % P)


def f2_neg(x):
    return (-x[0] % P, -x[1] % P)


def f2_conj(x):
    return (x[0], -x[1] % P)


def f2_inv(x):
    d = pow(x[0] * x[0] + x[1] * x[1], P - 2, P)
    return (x[0] * d % P, -x[1] * d % P)


def f2_pow(x, e):
    r = (1, 0)
    while e:
        if e & 1:
            r = f2_mul(r, x)
        x = f2_mul(x, x)
        e >>= 1
    return r


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)                      # the sextic twist constant 9 + u

# Fp6 elements: (c0, c1, c2) with v^3 = XI


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_mul(x, y):
    a = f2_mul(x[0], y[0])
    b = f2_mul(x[1], y[1])
    c = f2_mul(x[2], y[2])
    t0 = f2_add(a, f2_mul(XI, f2_sub(f2_mul(f2_add(x[1], x[2]),
                                            f2_add(y[1], y[2])),
                                     f2_add(b, c))))
    t1 = f2_add(f2_sub(f2_mul(f2_add(x[0], x[1]), f2_add(y[0], y[1])),
                       f2_add(a, b)), f2_mul(XI, c))
    t2 = f2_add(f2_sub(f2_mul(f2_add(x[0], x[2]), f2_add(y[0], y[2])),
                       f2_add(a, c)), b)
    return (t0, t1, t2)


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul_by_f2(x, k):
    return tuple(f2_mul(a, k) for a in x)


def f6_inv(x):
    c0 = f2_sub(f2_mul(x[0], x[0]), f2_mul(XI, f2_mul(x[1], x[2])))
    c1 = f2_sub(f2_mul(XI, f2_mul(x[2], x[2])), f2_mul(x[0], x[1]))
    c2 = f2_sub(f2_mul(x[1], x[1]), f2_mul(x[0], x[2]))
    t = f2_inv(f2_add(f2_mul(x[0], c0),
                      f2_mul(XI, f2_add(f2_mul(x[2], c1),
                                        f2_mul(x[1], c2)))))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)

# Fp12 elements: (c0, c1) over Fp6 with w^2 = v


def f12_mul(x, y):
    a = f6_mul(x[0], y[0])
    b = f6_mul(x[1], y[1])
    # b * v
    bv = (f2_mul(XI, b[2]), b[0], b[1])
    return (f6_add(a, bv),
            f6_sub(f6_mul(f6_add(x[0], x[1]), f6_add(y[0], y[1])),
                   f6_add(a, b)))


def f12_sq(x):
    return f12_mul(x, x)


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_inv(x):
    b2 = f6_mul(x[1], x[1])
    b2v = (f2_mul(XI, b2[2]), b2[0], b2[1])
    t = f6_inv(f6_sub(f6_mul(x[0], x[0]), b2v))
    return (f6_mul(x[0], t), f6_neg(f6_mul(x[1], t)))


def f12_pow(x, e):
    r = F12_ONE
    while e:
        if e & 1:
            r = f12_mul(r, x)
        x = f12_sq(x)
        e >>= 1
    return r


F12_ONE = (F6_ONE, F6_ZERO)

# Frobenius coefficients: gamma_1[i] = XI^(i*(p-1)/6)
_G1F = [f2_pow(XI, i * (P - 1) // 6) for i in range(6)]


def f2_frob(x):
    return f2_conj(x)


def f6_frob(x):
    return (f2_frob(x[0]),
            f2_mul(f2_frob(x[1]), _G1F[2]),
            f2_mul(f2_frob(x[2]), _G1F[4]))


def f12_frob(x):
    # (c0 + c1 w)^p = c0^p + c1^p * xi^((p-1)/6) * w; expanding c1^p's
    # per-coordinate v-gammas against the w-gamma gives the odd G1F's
    c0 = f6_frob(x[0])
    y = x[1]
    c1 = (f2_mul(f2_conj(y[0]), _G1F[1]),
          f2_mul(f2_conj(y[1]), _G1F[3]),
          f2_mul(f2_conj(y[2]), _G1F[5]))
    return (c0, c1)


# -- curve points -------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fp (affine tuples or None for infinity)
# G2: y'^2 = x'^3 + 3/XI over Fp2


B2 = f2_mul((3, 0), f2_inv(XI))


def g1_valid(pt):
    if pt is None:
        return True
    x, y = pt
    if x >= P or y >= P:
        return False
    return (y * y - x * x * x - 3) % P == 0


def g2_valid(pt):
    if pt is None:
        return True
    x, y = pt
    lhs = f2_mul(y, y)
    rhs = f2_add(f2_mul(f2_mul(x, x), x), B2)
    return lhs == rhs


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
    while k:
        if k & 1:
            r = g2_add(r, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return r


def g2_in_subgroup(pt) -> bool:
    return g2_mul(pt, R) is None


# -- optimal ate pairing ------------------------------------------------------


def _line(q1, q2, p):
    """Evaluate the line through q1, q2 (G2 affine) at p (G1 affine),
    returning a sparse Fp12 element (1 + c1*w + c3*v*w ... represented
    fully for simplicity)."""
    px, py = p
    if q1[0] == q2[0] and q1[1] == q2[1]:
        s = f2_mul(f2_scalar(f2_mul(q1[0], q1[0]), 3),
                   f2_inv(f2_scalar(q1[1], 2)))
    elif q1[0] == q2[0]:
        # vertical line x - x_Q: untwists to px - x'*v
        return (((px % P, 0), f2_neg(q1[0]), F2_ZERO), F6_ZERO)
    else:
        s = f2_mul(f2_sub(q2[1], q1[1]), f2_inv(f2_sub(q2[0], q1[0])))
    # The D-twist untwist is psi(x', y') = (x'*v, y'*v*w) (since v^3 = xi
    # and (v*w)^2 = xi), so the slope untwists as s'*w and
    #   l(P) = py - s'*px*w + (s'*x' - y')*v*w.
    # Fp12 layout x = (a0 + a1 v + a2 v^2) + (a3 + a4 v + a5 v^2) w:
    #   py at c0.a0; -s'*px at c1.a0; (s'x' - y') at c1.a1
    a = (py % P, 0)
    b = f2_sub(f2_mul(s, q1[0]), q1[1])
    c = f2_scalar(s, (-px) % P)
    return ((a, F2_ZERO, F2_ZERO), (c, b, F2_ZERO))


def miller_loop(q, p):
    """f_{6x+2,Q}(P) including the two Frobenius correction lines."""
    if q is None or p is None:
        return F12_ONE
    f = F12_ONE
    t = q
    bits = bin(ATE_LOOP)[3:]
    for bit in bits:
        f = f12_mul(f12_sq(f), _line(t, t, p))
        t = g2_add(t, t)
        if bit == "1":
            f = f12_mul(f, _line(t, q, p))
            t = g2_add(t, q)
    # Frobenius corrections: lines through Q1 = pi(Q) and -Q2 = -pi^2(Q)
    q1 = (f2_mul(f2_conj(q[0]), _G1F[2]), f2_mul(f2_conj(q[1]), _G1F[3]))
    g22 = f2_mul(_G1F[2], f2_conj(_G1F[2]))
    g23 = f2_mul(_G1F[3], f2_conj(_G1F[3]))
    nq2 = (f2_mul(q[0], g22), f2_neg(f2_mul(q[1], g23)))
    f = f12_mul(f, _line(t, q1, p))
    t = g2_add(t, q1)
    f = f12_mul(f, _line(t, nq2, p))
    return f


def final_exponentiation(f):
    # easy part: f^((p^6-1)(p^2+1))
    f1 = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6 - 1)
    f2 = f12_mul(f12_frob(f12_frob(f1)), f1)       # ^(p^2 + 1)
    # hard part: ^((p^4 - p^2 + 1)/r) by plain exponentiation
    e = (P**4 - P**2 + 1) // R
    return f12_pow(f2, e)


def pairing(q, p):
    """e(P in G1, Q in G2) in Fp12."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (the precompile-0x08 statement).

    pairs: [(g1_point | None, g2_point | None)]. Raises ValueError on
    points not on curve / not in the G2 subgroup.
    """
    f = F12_ONE
    for p1, q2 in pairs:
        if not g1_valid(p1):
            raise ValueError("g1 point not on curve")
        if not g2_valid(q2):
            raise ValueError("g2 point not on curve")
        if q2 is not None and not g2_in_subgroup(q2):
            raise ValueError("g2 point not in subgroup")
        if p1 is None or q2 is None:
            continue
        f = f12_mul(f, miller_loop(q2, p1))
    return final_exponentiation(f) == F12_ONE
