"""384-bit modular-multiply accelerator circuit: prove batches of
a*b mod m claims.

TPU-native replacement for risc0-bigint2 1.4.6 (SURVEY.md §2.2,
guests/stateless-client/Cargo.lock:4034-4041): the programmable bigint
accelerator that backs k256 (ECDSA recover) and blst inside the
reference guest. The width is 384 bits so one modmul covers BLS12-381
base-field arithmetic (the guest KZG precompile); 256-bit users
(secp256k1, bn254, MULMOD) zero-pad their operands. Like the keccak accelerator (circuits/keccak.py), ops
are recorded by the executor via syscall and proven here as a standalone
STARK batch, linked to the main proof by an IO RLC.

One op per trace row. All quantities in 24-limb little-endian 16-bit
limb form, each limb bit-decomposed (booleanity + weighted recompose
keep every limb in [0, 2^16), the same range discipline as the rv32im
AIR). Witness columns per row:

  a,b,m,r[24x16 bits each]   operands and remainder  (public, RLC-bound)
  q[24x16 bits]              quotient (private witness)
  carry[47x(CARRY_BITS+1)]   signed carries of the convolution identity,
                             offset-encoded: carry_k + 2^CARRY_BITS
  brw[24 bits]          borrow chain bits of the r < m check

Soundness: with every limb < 2^16 and carries bounded, the row-local
identity

    sum_k (conv_k(a,b) - conv_k(q,m) - r_k) 2^(16k) = 0

holds over the integers, i.e. a*b = q*m + r exactly; the borrow chain
proves r < m (so r is the canonical remainder) whenever m != 0. The
m == 0 encoding is reserved (the executor never emits it; the verifier's
parse_publics rejects it).

Constraint degrees stay <= 3 (limb recompose is linear in bits; conv
terms are products of two linear forms).

Port note: a jax-free copy of ``zeth_tpu.circuits.bigint2``. The AIR is
unchanged. Two host functions compute the reference's values in bulk,
because a block's batch carries millions of public limbs: the derived
challenge (``hostmath.ext_rlc`` instead of a Python loop per limb) and
the claims digest (one long sponge row, hashed by the leaf kernel on
`device`). ``prove_batch`` runs on the port's prover on `device` (None:
the CUDA card). The recursion hooks (``publics_shape``,
``derived_challenges_rec``) come from ``circuits.resolve``.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..zkp import proof as proof_mod
from ..zkp import prover as prover_mod
from ..zkp import verifier as verifier_mod
from ..zkp.air import Air
from .resolve import LimbStreamResolve

LIMBS = 24                   # 24 x 16-bit = 384 bits
NK = 2 * LIMBS - 1           # convolution positions 0..46
CARRY_BITS = 22              # |carry| < 24*(2^16)^2 / 2^16 + slack < 2^21

# main column offsets (all bit columns)
A_OFF = 0
B_OFF = A_OFF + LIMBS * 16
M_OFF = B_OFF + LIMBS * 16
Q_OFF = M_OFF + LIMBS * 16
R_OFF = Q_OFF + LIMBS * 16
CAR_OFF = R_OFF + LIMBS * 16                 # NK x (CARRY_BITS+1)
BRW_OFF = CAR_OFF + NK * (CARRY_BITS + 1)    # LIMBS borrow bits
E_OFF = BRW_OFF + LIMBS                      # LIMBS x 16: e = m - r - 1 + B*2^256
ACT_COL = E_OFF + LIMBS * 16                 # row carries a claimed op
N_MAIN = ACT_COL + 1

# control columns
CT_ISF, CT_ISL = 0, 1
N_CONTROL = 2


class Bigint2Air(LimbStreamResolve, Air):
    """Batch of 384-bit modmul ops, one per row."""

    name = "bigint2-modmul384"
    control_cols = N_CONTROL
    main_cols = N_MAIN
    aux_cols = 4                  # the IO RLC chain (one ext slot)
    n_challenges = 1              # gamma
    n_derived = 1                 # expected RLC of the public IO limbs
    n_public_scalars = 0
    main_bit_mask = np.ones(N_MAIN, dtype=bool)

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        cols[0, CT_ISF] = 1
        cols[-1, CT_ISL] = 1
        return cols

    # -- IO binding (same RLC pattern as the keccak accelerator) -----------

    def derived_challenges(self, publics, challenges, extra=None):
        """RLC of the public limb stream, sum_i limb_i gamma^(L-1-i)."""
        limbs = parse_publics(publics, flat_limbs=True)
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        return H.ext_rlc(limbs, gamma)[None, :]

    def build_aux(self, main_std, challenges):
        main_std = np.asarray(main_std, np.uint64)
        n = main_std.shape[0]
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        glimb = H.ext_pow(gamma, 4 * LIMBS)
        gp_rev = H.ext_powers(gamma, 4 * LIMBS)[::-1]
        # per-row public limbs: a,b,m,r (4*LIMBS 16-bit values)
        weights = (np.uint64(1) << np.arange(16, dtype=np.uint64))
        def limbs_of(off):
            bits = main_std[:, off:off + LIMBS * 16].reshape(n, LIMBS, 16)
            return (bits * weights[None, None, :]).sum(axis=2)
        row_limbs = np.concatenate(
            [limbs_of(A_OFF), limbs_of(B_OFF), limbs_of(M_OFF),
             limbs_of(R_OFF)], axis=1)                     # (n, 64)
        act = main_std[:, ACT_COL] == 1
        col = np.zeros((n, 4), dtype=np.uint64)
        r = np.zeros(4, dtype=np.uint64)
        for i in range(n):
            if act[i]:
                acc = ((gp_rev * row_limbs[i][:, None]) % H.PU).sum(axis=0) \
                    % H.PU
                r = H.ext_add(H.ext_mul(r, glimb), acc)
            col[i] = r
        return col

    # -- witgen ------------------------------------------------------------

    @staticmethod
    def witgen(ops: np.ndarray, po2: int) -> tuple[np.ndarray, list]:
        """ops: (nop, 3) object/int array of (a, b, m) big ints ->
        (main_std (n, cols), publics)."""
        n = 1 << po2
        nop = len(ops)
        assert nop <= n
        m = np.zeros((n, N_MAIN), dtype=np.uint8)
        publics = [nop]
        for i, (a, b, mod) in enumerate(ops):
            a, b, mod = int(a), int(b), int(mod)
            assert 0 < mod < (1 << 384) and 0 <= a < (1 << 384) \
                and 0 <= b < (1 << 384)
            q, r = divmod(a * b, mod)
            assert q < (1 << 384), "quotient overflow (a*b >= m << 384)"
            al = _limbs(a); bl = _limbs(b); ml = _limbs(mod)
            ql = _limbs(q); rl = _limbs(r)
            for off, ls in ((A_OFF, al), (B_OFF, bl), (M_OFF, ml),
                            (Q_OFF, ql), (R_OFF, rl)):
                for li, lv in enumerate(ls):
                    for z in range(16):
                        m[i, off + li * 16 + z] = (lv >> z) & 1
            # carry chain: t_k = conv_k(a,b) - conv_k(q,m) - r_k + c_{k-1}
            #              t_k = c_k * 2^16
            c = 0
            for k in range(NK):
                conv_ab = sum(al[i2] * bl[k - i2]
                              for i2 in range(max(0, k - LIMBS + 1),
                                              min(k, LIMBS - 1) + 1))
                conv_qm = sum(ql[i2] * ml[k - i2]
                              for i2 in range(max(0, k - LIMBS + 1),
                                              min(k, LIMBS - 1) + 1))
                t = conv_ab - conv_qm - (rl[k] if k < LIMBS else 0) + c
                assert t % (1 << 16) == 0
                c = t >> 16
                enc = c + (1 << CARRY_BITS)
                assert 0 <= enc < (1 << (CARRY_BITS + 1)), "carry overflow"
                for z in range(CARRY_BITS + 1):
                    m[i, CAR_OFF + k * (CARRY_BITS + 1) + z] = (enc >> z) & 1
            assert c == 0
            # borrow chain for r < m: e = m - r - 1 (no final borrow)
            e = mod - r - 1
            assert e >= 0
            el = _limbs(e)
            brw = 0
            for li in range(LIMBS):
                d = ml[li] - rl[li] - (1 if li == 0 else 0) - brw
                brw = 1 if d < 0 else 0
                m[i, BRW_OFF + li] = brw
                for z in range(16):
                    m[i, E_OFF + li * 16 + z] = (el[li] >> z) & 1
            assert brw == 0
            m[i, ACT_COL] = 1
            for v in (a, b, mod, r):
                publics += _limbs(v)
        return m.astype(np.uint64), publics

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        from ..zkp.air import cadd, cext, cmul, cmul_base, csub
        add, sub, mul = ops.add, ops.sub, ops.mul
        one = ops.const(1)
        cs = []

        def boolc(e):
            return mul(e, sub(e, one))

        act = v("main", ACT_COL)
        isf = v("control", CT_ISF)
        isl = v("control", CT_ISL)
        not_last = sub(one, isl)

        # booleanity of every main column
        for j in range(N_MAIN):
            cs.append(boolc(v("main", j)))

        def limb(off, li, row_off=0):
            acc = None
            for z in range(16):
                t = mul(ops.const(1 << z), v("main", off + li * 16 + z,
                                             row_off))
                acc = t if acc is None else add(acc, t)
            return acc

        a = [limb(A_OFF, i) for i in range(LIMBS)]
        b = [limb(B_OFF, i) for i in range(LIMBS)]
        mm = [limb(M_OFF, i) for i in range(LIMBS)]
        q = [limb(Q_OFF, i) for i in range(LIMBS)]
        r = [limb(R_OFF, i) for i in range(LIMBS)]
        e = [limb(E_OFF, i) for i in range(LIMBS)]

        def carry(k):
            acc = None
            for z in range(CARRY_BITS + 1):
                t = mul(ops.const(1 << z),
                        v("main", CAR_OFF + k * (CARRY_BITS + 1) + z))
                acc = t if acc is None else add(acc, t)
            # subtract the offset 2^CARRY_BITS
            return sub(acc, ops.const(1 << CARRY_BITS))

        # convolution identity with carries, gated by act (inactive rows
        # leave q/carries unconstrained, which is sound: their a,b,m,r
        # are forced to zero below and the RLC chain skips them)
        prev_c = None
        for k in range(NK):
            conv = None
            for i2 in range(max(0, k - LIMBS + 1), min(k, LIMBS - 1) + 1):
                t = sub(mul(a[i2], b[k - i2]), mul(q[i2], mm[k - i2]))
                conv = t if conv is None else add(conv, t)
            t = conv
            if k < LIMBS:
                t = sub(t, r[k])
            if prev_c is not None:
                t = add(t, prev_c)
            ck = carry(k)
            cs.append(mul(act, sub(t, mul(ops.const(1 << 16), ck))))
            prev_c = ck
        cs.append(mul(act, prev_c))        # final carry = 0

        # r < m (active rows): m - r - 1 = e with a vanishing borrow chain
        # limb-wise: m_i - r_i - [i==0] - brw_{i-1} + 2^16*brw_i = e_i
        prev_b = None
        for li in range(LIMBS):
            d = sub(mm[li], r[li])
            if li == 0:
                d = sub(d, one)
            if prev_b is not None:
                d = sub(d, prev_b)
            bi = v("main", BRW_OFF + li)
            d = add(d, mul(ops.const(1 << 16), bi))
            cs.append(mul(act, sub(d, e[li])))
            prev_b = bi
        cs.append(mul(act, prev_b))      # no final borrow

        # inactive rows are identically zero (keeps the RLC honest and
        # the ungated conv identity trivially satisfied)
        for off in (A_OFF, B_OFF, M_OFF, R_OFF):
            for li in range(LIMBS):
                cs.append(mul(sub(one, act), limb(off, li)))

        # active rows form a prefix: act can only fall, never rise
        cs.append(mul(not_last, mul(v("main", ACT_COL, 1),
                                    sub(one, act))))

        # --- IO RLC binding ----------------------------------------------
        gamma = challenges[0]
        d_rlc = challenges[1]
        gpow = [cext(ops, 1)]
        for _ in range(4 * LIMBS):
            gpow.append(cmul(ops, gpow[-1], gamma))

        def row_lin(row_off=0):
            acc = None
            j = 0
            for off in (A_OFF, B_OFF, M_OFF, R_OFF):
                for li in range(LIMBS):
                    t = cmul_base(ops, gpow[4 * LIMBS - 1 - j],
                                  limb(off, li, row_off))
                    acc = t if acc is None else cadd(ops, acc, t)
                    j += 1
            return acc

        rr = tuple(v("aux", c) for c in range(4))
        rn = tuple(v("aux", c, 1) for c in range(4))
        first_val = cmul_base(ops, row_lin(), act)
        cs.extend(cmul_base(ops, csub(ops, rr, first_val), isf))
        act_n = v("main", ACT_COL, 1)
        stepped = cadd(ops, cmul(ops, rr, gpow[4 * LIMBS]), row_lin(1))
        mix = cadd(ops, cmul_base(ops, csub(ops, rn, stepped), act_n),
                   cmul_base(ops, csub(ops, rn, rr), sub(one, act_n)))
        cs.extend(cmul_base(ops, mix, not_last))
        cs.extend(cmul_base(ops, csub(ops, rr, d_rlc), isl))
        return cs


def _limbs(x: int) -> list[int]:
    return [(x >> (16 * i)) & 0xFFFF for i in range(LIMBS)]


def parse_publics(pubs, flat_limbs: bool = False):
    """Decode the public IO: [nop, then per op 4*LIMBS 16-bit limbs of
    (a, b, m, r)]. Returns [(a, b, m, r)] big ints, or the flat limb
    list when flat_limbs (the RLC stream)."""
    p = [int(x) for x in pubs]
    if not p:
        raise ValueError("empty bigint2 publics")
    nop = p[0]
    if len(p) != 1 + 4 * LIMBS * nop:
        raise ValueError("bad bigint2 publics length")
    if any(x < 0 or x >= (1 << 16) for x in p[1:]):
        raise ValueError("bigint2 limb out of range")
    if flat_limbs:
        return p[1:]
    out = []
    for i in range(nop):
        vals = []
        off = 1 + 4 * LIMBS * i
        for j in range(4):
            limbs = p[off + j * LIMBS: off + (j + 1) * LIMBS]
            vals.append(sum(lv << (16 * k) for k, lv in enumerate(limbs)))
        a, b, m, r = vals
        if m == 0:
            raise ValueError("bigint2 op with zero modulus")
        out.append((a, b, m, r))
    return out


def claims_limbs(io: list[tuple]) -> np.ndarray:
    """The proof-bound (a, b, m, r) stream as 16-bit limbs: the one row
    ``claims_digest`` hashes."""
    raw = b"".join(int(v).to_bytes(2 * LIMBS, "little")
                   for op in io for v in op)
    return np.frombuffer(raw, dtype="<u2")


def claims_digest(io: list[tuple], device=None) -> np.ndarray:
    """Poseidon2 digest over the proof-bound (a, b, m, r) limb stream,
    hashed on `device` (None: the CUDA card)."""
    return P2.sponge_row(claims_limbs(io), device)


def choose_po2(nop: int) -> int:
    return max(6, int(np.ceil(np.log2(max(nop, 2)))))


def prove_batch(ops: np.ndarray, device=None):
    """Prove a batch of modmul ops [(a, b, m)] on `device` (None: the CUDA
    card; without one the call raises); returns (seal, digest)."""
    device = resolve_device(device)
    air = Bigint2Air()
    po2 = choose_po2(len(ops))
    with prover_mod._Stage("bigint witgen (host)", device):
        main, publics = Bigint2Air.witgen(ops, po2)
    pf = prover_mod.prove(air, main, publics, device=device)
    with prover_mod._Stage("claims digest", device):
        digest = claims_digest(parse_publics(pf.publics), device)
    return proof_mod.encode(pf), digest


def verify_batch(seal, device=None) -> list[tuple]:
    """Verify an accelerator seal (the control root on `device`, None: the
    CUDA card); returns the proof-bound (a, b, m, r) claims for the
    caller to link against the main proof's bound IO."""
    pf = proof_mod.decode(seal)
    verifier_mod.verify(Bigint2Air(), pf, pf.publics, device=device)
    return parse_publics(pf.publics)
