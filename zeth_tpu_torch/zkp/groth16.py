"""Groth16 over BN254: verifier + R1CS/QAP prover (risc0-groth16 role).

The reference shrink-wraps a succinct STARK receipt into a constant-size
BN254 Groth16 proof for cheap on-chain verification (SURVEY.md §2.2,
risc0-groth16 3.0.2 / arkworks). This module implements:

  * the verification equation
      e(A, B) = e(alpha, beta) * e(sum_i pub_i * IC_i, gamma) * e(C, delta)
    so receipts wrapped by an external prover can be checked natively;
  * a complete proving path — R1CS constraint system, QAP conversion
    over the 2-adic subgroup of the BN254 scalar field, `setup()` and
    `prove()` — exercised end-to-end by tests/test_bn254.py.

`setup()` generates the CRS from locally sampled toxic waste: fine for
development, testing and benchmarks, **not for production** — a real
deployment must obtain the CRS from a multi-party ceremony (the
reference inherits circom/snarkjs artifacts from its ceremony). The
remaining integration step for receipt wrapping is expressing this
framework's succinct-receipt verifier as an R1CS circuit (the
reference's identity_p254 + stark_verify circom circuit, which risc0
ships pre-built); until then receipts stay in succinct STARK form.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..app import bn254 as B


def _g1_add(p1, p2):
    P = B.P
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
    k %= B.R
    while k:
        if k & 1:
            r = _g1_add(r, pt)
        pt = _g1_add(pt, pt)
        k >>= 1
    return r


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % B.P)


@dataclass
class VerifyingKey:
    alpha_g1: tuple            # G1
    beta_g2: tuple             # G2
    gamma_g2: tuple
    delta_g2: tuple
    ic: list                   # G1 points, len = n_publics + 1


@dataclass
class Proof:
    a: tuple                   # G1
    b: tuple                   # G2
    c: tuple                   # G1


class Groth16Error(Exception):
    pass


# ---------------------------------------------------------------------------
# R1CS -> QAP -> prove
# ---------------------------------------------------------------------------

# BN254 G1/G2 generators (standard: g1 = (1, 2); g2 from the pairing spec)
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


@dataclass
class R1CS:
    """Rank-1 constraint system over the BN254 scalar field r.

    Wires: w[0] = 1, w[1..n_pub] = public inputs, the rest private.
    Each constraint is (A, B, C) sparse rows as {wire: coeff} with
    <A,w> * <B,w> = <C,w>.
    """
    n_wires: int
    n_pub: int
    constraints: list          # [(dict, dict, dict)]

    def check(self, w: list[int]) -> bool:
        r = B.R
        for a, b, c in self.constraints:
            av = sum(v * w[i] for i, v in a.items()) % r
            bv = sum(v * w[i] for i, v in b.items()) % r
            cv = sum(v * w[i] for i, v in c.items()) % r
            if av * bv % r != cv:
                return False
        return True


@dataclass
class ProvingKey:
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: list              # [u_i(tau)]_1 per wire
    b_g1_query: list           # [v_i(tau)]_1 per wire
    b_g2_query: list           # [v_i(tau)]_2 per wire
    l_query: list              # [(beta u_i + alpha v_i + w_i)/delta]_1, private wires
    h_query: list              # [tau^j Z(tau)/delta]_1, j < m-1
    domain_m: int


def _fr_root_of_unity(m: int) -> int:
    """Order-m root of unity in F_r (r - 1 = 2^28 * odd; generator 5)."""
    r = B.R
    k = m.bit_length() - 1
    assert 1 << k == m and k <= 28, f"bad QAP domain size {m}"
    return pow(5, (r - 1) >> k, r)


def _fft_fr(vals: list[int], inverse: bool) -> list[int]:
    """Radix-2 NTT over F_r (python ints; QAP domains are small)."""
    r = B.R
    m = len(vals)
    w = _fr_root_of_unity(m)
    if inverse:
        w = pow(w, r - 2, r)
    out = list(vals)
    # bit-reverse
    j = 0
    for i in range(1, m):
        bit = m >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            out[i], out[j] = out[j], out[i]
    s = 2
    while s <= m:
        wm = pow(w, m // s, r)
        for off in range(0, m, s):
            wj = 1
            for j2 in range(s // 2):
                u = out[off + j2]
                t = out[off + j2 + s // 2] * wj % r
                out[off + j2] = (u + t) % r
                out[off + j2 + s // 2] = (u - t) % r
                wj = wj * wm % r
        s <<= 1
    if inverse:
        mi = pow(m, r - 2, r)
        out = [v * mi % r for v in out]
    return out


def _qap_evals_at(r1cs: R1CS, tau: int, m: int):
    """u_i(tau), v_i(tau), w_i(tau) per wire, plus Z(tau).

    u_i interpolates column i of the A matrix over the size-m domain
    (constraint q -> Lagrange node w^q); dev-setup-only shortcut — the
    setup knows tau, so Lagrange values L_q(tau) are computed directly.
    """
    r = B.R
    w = _fr_root_of_unity(m)
    z_tau = (pow(tau, m, r) - 1) % r
    m_inv = pow(m, r - 2, r)
    # L_q(tau) = Z(tau) * w^q / (m * (tau - w^q))
    lag = []
    wq = 1
    for q in range(m):
        lag.append(z_tau * wq % r * m_inv % r
                   * pow((tau - wq) % r, r - 2, r) % r)
        wq = wq * w % r
    u = [0] * r1cs.n_wires
    v = [0] * r1cs.n_wires
    ww = [0] * r1cs.n_wires
    for q, (a, b, c) in enumerate(r1cs.constraints):
        lq = lag[q]
        for i, coeff in a.items():
            u[i] = (u[i] + coeff * lq) % r
        for i, coeff in b.items():
            v[i] = (v[i] + coeff * lq) % r
        for i, coeff in c.items():
            ww[i] = (ww[i] + coeff * lq) % r
    return u, v, ww, z_tau


def setup(r1cs: R1CS, rng=None) -> ProvingKey:
    """Dev-mode CRS generation from locally sampled toxic waste.

    INSECURE for production (whoever runs setup can forge proofs);
    production CRSs come from a multi-party ceremony. Matches the role
    of the reference's pre-built snarkjs artifacts for local use.
    """
    import secrets
    r = B.R
    rand = (lambda: secrets.randbelow(r - 1) + 1) if rng is None else rng
    tau, alpha, beta, gamma, delta = (rand() for _ in range(5))
    m = 1
    while m < max(len(r1cs.constraints), 2):
        m <<= 1
    u, v, w, z_tau = _qap_evals_at(r1cs, tau, m)

    g1 = lambda k: g1_mul(G1_GEN, k % r)
    g2 = lambda k: B.g2_mul(G2_GEN, k % r)
    gamma_inv = pow(gamma, r - 2, r)
    delta_inv = pow(delta, r - 2, r)

    ic = [g1((beta * u[i] + alpha * v[i] + w[i]) % r * gamma_inv)
          for i in range(r1cs.n_pub + 1)]
    l_query = [g1((beta * u[i] + alpha * v[i] + w[i]) % r * delta_inv)
               for i in range(r1cs.n_pub + 1, r1cs.n_wires)]
    h_query = []
    t_pow = 1
    for _ in range(m - 1):
        h_query.append(g1(t_pow * z_tau % r * delta_inv))
        t_pow = t_pow * tau % r

    vk = VerifyingKey(alpha_g1=g1(alpha), beta_g2=g2(beta),
                      gamma_g2=g2(gamma), delta_g2=g2(delta), ic=ic)
    return ProvingKey(
        vk=vk, beta_g1=g1(beta), delta_g1=g1(delta),
        a_query=[g1(u[i]) for i in range(r1cs.n_wires)],
        b_g1_query=[g1(v[i]) for i in range(r1cs.n_wires)],
        b_g2_query=[g2(v[i]) for i in range(r1cs.n_wires)],
        l_query=l_query, h_query=h_query, domain_m=m)


def _msm_g1(points, scalars):
    acc = None
    for pt, k in zip(points, scalars):
        if k % B.R == 0 or pt is None:
            continue
        acc = _g1_add(acc, g1_mul(pt, k))
    return acc


def _msm_g2(points, scalars):
    acc = None
    for pt, k in zip(points, scalars):
        if k % B.R == 0 or pt is None:
            continue
        acc = B.g2_add(acc, B.g2_mul(pt, k)) if acc is not None \
            else B.g2_mul(pt, k)
    return acc


def prove(pk: ProvingKey, r1cs: R1CS, witness: list[int],
          rng=None) -> Proof:
    """Produce a Groth16 proof for a full wire assignment.

    witness: all wire values incl. w[0]=1 and the publics. Raises
    Groth16Error if the assignment does not satisfy the R1CS.
    """
    import secrets
    r = B.R
    if len(witness) != r1cs.n_wires:
        raise Groth16Error("wire count mismatch")
    w_vals = [int(x) % r for x in witness]
    if w_vals[0] != 1:
        raise Groth16Error("wire 0 must be 1")
    if not r1cs.check(w_vals):
        raise Groth16Error("witness does not satisfy the constraint system")
    m = pk.domain_m

    # h(X) = (A(X)B(X) - C(X)) / Z(X) via coset evaluation: evaluate the
    # degree-<m polynomials A,B,C on the shifted domain s*H (Z has no
    # zeros there), divide pointwise, interpolate h back.
    a_evs = [0] * m
    b_evs = [0] * m
    c_evs = [0] * m
    for q, (a, b, c) in enumerate(r1cs.constraints):
        a_evs[q] = sum(v * w_vals[i] for i, v in a.items()) % r
        b_evs[q] = sum(v * w_vals[i] for i, v in b.items()) % r
        c_evs[q] = sum(v * w_vals[i] for i, v in c.items()) % r
    a_c = _fft_fr(a_evs, inverse=True)
    b_c = _fft_fr(b_evs, inverse=True)
    c_c = _fft_fr(c_evs, inverse=True)
    s_shift = 5                        # multiplicative generator of F_r^*
    sp = 1
    a_s, b_s, c_s = [], [], []
    for j in range(m):
        a_s.append(a_c[j] * sp % r)
        b_s.append(b_c[j] * sp % r)
        c_s.append(c_c[j] * sp % r)
        sp = sp * s_shift % r
    a_ev = _fft_fr(a_s, inverse=False)
    b_ev = _fft_fr(b_s, inverse=False)
    c_ev = _fft_fr(c_s, inverse=False)
    z_coset_inv = pow((pow(s_shift, m, r) - 1) % r, r - 2, r)
    h_ev = [(a_ev[j] * b_ev[j] - c_ev[j]) % r * z_coset_inv % r
            for j in range(m)]
    h_s = _fft_fr(h_ev, inverse=True)
    s_inv = pow(s_shift, r - 2, r)
    sp = 1
    h_c = []
    for j in range(m):
        h_c.append(h_s[j] * sp % r)
        sp = sp * s_inv % r
    assert h_c[m - 1] == 0 or len(pk.h_query) >= m, \
        "h degree exceeds CRS H-query"

    rand = (lambda: secrets.randbelow(r)) if rng is None else rng
    rr, ss = rand(), rand()

    a_pt = _msm_g1([pk.vk.alpha_g1] + pk.a_query + [pk.delta_g1],
                   [1] + w_vals + [rr])
    b_pt2 = _msm_g2([pk.vk.beta_g2] + pk.b_g2_query + [pk.vk.delta_g2],
                    [1] + w_vals + [ss])
    b_pt1 = _msm_g1([pk.beta_g1] + pk.b_g1_query + [pk.delta_g1],
                    [1] + w_vals + [ss])
    priv = w_vals[r1cs.n_pub + 1:]
    c_pt = _msm_g1(
        pk.l_query + pk.h_query + [a_pt, b_pt1, pk.delta_g1],
        priv + h_c[:len(pk.h_query)] + [ss, rr, (-rr * ss) % r])
    return Proof(a=a_pt, b=b_pt2, c=c_pt)


def verify(vk: VerifyingKey, proof: Proof, publics: list[int]) -> None:
    """Raise Groth16Error unless the proof verifies."""
    if len(publics) + 1 != len(vk.ic):
        raise Groth16Error("public input count mismatch")
    for pt in (proof.a, proof.c, vk.alpha_g1, *vk.ic):
        if not B.g1_valid(pt):
            raise Groth16Error("invalid G1 point")
    for pt in (proof.b, vk.beta_g2, vk.gamma_g2, vk.delta_g2):
        if not B.g2_valid(pt) or (pt is not None
                                  and not B.g2_in_subgroup(pt)):
            raise Groth16Error("invalid G2 point")
    acc = vk.ic[0]
    for coeff, base in zip(publics, vk.ic[1:]):
        acc = _g1_add(acc, g1_mul(base, int(coeff)))
    # e(-A, B) * e(alpha, beta) * e(acc, gamma) * e(C, delta) == 1
    ok = B.pairing_check([
        (g1_neg(proof.a), proof.b),
        (vk.alpha_g1, vk.beta_g2),
        (acc, vk.gamma_g2),
        (proof.c, vk.delta_g2),
    ])
    if not ok:
        raise Groth16Error("pairing equation does not hold")
