"""Frozen copy of ``zeth_tpu_torch/circuits/keccak.py`` (the keccak-f[1600]
batch AIR: its layout, control trace, derived challenge, constraints and
publics; no witness generation); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..keccakf import PI_ROT as _PI_ROT, PI_SRC as _PI_SRC, RC as _RC
from ..zkp.air import Air


ROWS_PER_PERM = 32
ROUNDS = 24

# main column offsets
S_OFF = 0
C_OFF = 1600
W0_OFF = C_OFF + 320
W1_OFF = W0_OFF + 320
T_OFF = W1_OFF + 320
BA_COL = T_OFF + 1600        # blk_active: this 32-row block carries a
                             # claimed permutation (bound to the publics)
N_MAIN = BA_COL + 1

# control: is_input, rnd_active, grc[64] (= rnd_active * iota rc bit z),
# is_output (row 24 = final state), is_blk_last (row 31), is_first/last
CT_INPUT, CT_ACTIVE = 0, 1
CT_GRC = 2
CT_OUTPUT = CT_GRC + 64
CT_BLK_LAST = CT_OUTPUT + 1
CT_ISF = CT_BLK_LAST + 1
CT_ISL = CT_ISF + 1
N_CONTROL = CT_ISL + 1


def _s_col(lane: int, z: int) -> int:
    return S_OFF + lane * 64 + z


def _c_col(x: int, z: int) -> int:
    return C_OFF + x * 64 + z


def _t_col(lane: int, z: int) -> int:
    return T_OFF + lane * 64 + z


# chi reads b[x,y,z] where b[j] = rotl64(t[PI_SRC[j]], PI_ROT[j]):
# b[j] bit z = t[PI_SRC[j]] bit (z - PI_ROT[j]) mod 64
def _b_col(lane: int, z: int) -> int:
    return _t_col(int(_PI_SRC[lane]), (z - int(_PI_ROT[lane])) % 64)


class KeccakAir(Air):
    """Batch of keccak-f[1600] permutations, 32 rows each."""

    name = "keccak-f1600"
    control_cols = N_CONTROL
    main_cols = N_MAIN
    aux_cols = 4                  # one ext slot: the IO RLC chain
    n_challenges = 1              # gamma for the RLC
    n_derived = 1                 # expected RLC of the public IO limbs
    n_public_scalars = 0
    main_bit_mask = np.ones(N_MAIN, dtype=bool)

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        r = np.arange(n) % ROWS_PER_PERM
        cols[:, CT_INPUT] = r == 0
        cols[:, CT_ACTIVE] = r < ROUNDS
        for z in range(64):
            rc_bits = np.array([(_RC[int(rr)] >> z) & 1 if rr < ROUNDS else 0
                                for rr in r], dtype=np.uint64)
            cols[:, CT_GRC + z] = rc_bits * cols[:, CT_ACTIVE]
        cols[:, CT_OUTPUT] = r == ROUNDS
        cols[:, CT_BLK_LAST] = r == ROWS_PER_PERM - 1
        cols[0, CT_ISF] = 1
        cols[-1, CT_ISL] = 1
        return cols

    # -- IO binding --------------------------------------------------------

    def derived_challenges(self, publics, challenges, extra=None):
        words = parse_publics(publics)
        from .rv32im import _rlc
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        return _rlc(words, gamma)[None, :]

    # -- witgen ------------------------------------------------------------

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        from ..zkp.air import cadd, cext, cmul, cmul_base, csub
        add, sub, mul = ops.add, ops.sub, ops.mul
        one = ops.const(1)
        two = ops.const(2)
        cs = []

        def boolc(e):
            return mul(e, sub(e, one))

        is_input = v("control", CT_INPUT)
        active = v("control", CT_ACTIVE)
        is_output = v("control", CT_OUTPUT)
        blk_last = v("control", CT_BLK_LAST)
        isf = v("control", CT_ISF)
        isl = v("control", CT_ISL)
        not_last = sub(one, isl)
        ba = v("main", BA_COL)

        # --- IO RLC binding (challenge gamma; derived expected value) -----
        cs.append(boolc(ba))
        # blk_active is constant within each 32-row block
        cs.append(mul(sub(one, blk_last), sub(v("main", BA_COL, 1), ba)))

        gamma = challenges[0]
        d_rlc = challenges[1]
        gpow = [cext(ops, 1)]
        for _ in range(100):
            gpow.append(cmul(ops, gpow[-1], gamma))   # scalar-only: free

        def state_limb(j, off=0):
            acc = None
            for k in range(16):
                term = mul(ops.const(1 << k), v("main", S_OFF + 16 * j + k,
                                                off))
                acc = term if acc is None else add(acc, term)
            return acc

        def absorb_lin(off=0):
            acc = None
            for j in range(100):
                term = cmul_base(ops, gpow[99 - j], state_limb(j, off))
                acc = term if acc is None else cadd(ops, acc, term)
            return acc

        r = tuple(v("aux", c) for c in range(4))
        rn = tuple(v("aux", c, 1) for c in range(4))
        act = mul(ba, add(is_input, is_output))
        act_n = mul(v("main", BA_COL, 1),
                    add(v("control", CT_INPUT, 1), v("control", CT_OUTPUT, 1)))
        # row 0 is an input row: r(0) = act * L(0)
        first_val = cmul_base(ops, absorb_lin(), act)
        cs.extend(cmul_base(ops, csub(ops, r, first_val), isf))
        # transition: rn = act_n ? r*g^100 + L_n : r
        stepped = cadd(ops, cmul(ops, r, gpow[100]), absorb_lin(1))
        mix = cadd(ops, cmul_base(ops, csub(ops, rn, stepped), act_n),
                   cmul_base(ops, csub(ops, rn, r), sub(one, act_n)))
        cs.extend(cmul_base(ops, mix, not_last))
        # final value equals the host-derived RLC of the public IO
        cs.extend(cmul_base(ops, csub(ops, r, d_rlc), isl))

        # input-row state booleanity (later rows inherit from transitions)
        for j in range(1600):
            cs.append(mul(is_input, boolc(v("main", S_OFF + j))))
        # parity slack booleanity
        for off in (C_OFF, W0_OFF, W1_OFF):
            for j in range(320):
                cs.append(boolc(v("main", off + j)))
        # theta parity decomposition
        for x in range(5):
            for z in range(64):
                s = v("main", _s_col(x, z))
                for y in range(1, 5):
                    s = add(s, v("main", _s_col(x + 5 * y, z)))
                rhs = add(v("main", _c_col(x, z)),
                          add(mul(two, v("main", W0_OFF + x * 64 + z)),
                              mul(ops.const(4), v("main", W1_OFF + x * 64 + z))))
                cs.append(sub(s, rhs))
        # theta output: t = s xor d, d = c[x-1,z] xor c[x+1,z-1]
        for lane in range(25):
            x = lane % 5
            for z in range(64):
                c1 = v("main", _c_col((x - 1) % 5, z))
                c2 = v("main", _c_col((x + 1) % 5, (z - 1) % 64))
                d = sub(add(c1, c2), mul(two, mul(c1, c2)))
                s = v("main", _s_col(lane, z))
                want = sub(add(s, d), mul(two, mul(s, d)))
                cs.append(sub(v("main", _t_col(lane, z)), want))
        # chi + iota transition: next-row s = chi(rho_pi(t)) xor rc
        for x in range(5):
            for y in range(5):
                lane = x + 5 * y
                for z in range(64):
                    b0 = v("main", _b_col(lane, z))
                    b1 = v("main", _b_col((x + 1) % 5 + 5 * y, z))
                    b2 = v("main", _b_col((x + 2) % 5 + 5 * y, z))
                    u = mul(sub(one, b1), b2)
                    vexpr = add(b0, mul(u, sub(one, mul(two, b0))))
                    nxt = v("main", _s_col(lane, z), 1)
                    con = mul(active, sub(nxt, vexpr))
                    if lane == 0:
                        grc = v("control", CT_GRC + z)
                        con = sub(con, mul(grc, sub(one, mul(two, vexpr))))
                    cs.append(con)
        return cs


def parse_publics(pubs) -> list[int]:
    """Decode the public IO: flat 32-bit words (per claimed permutation:
    50 input words then 50 output words, state memory order)."""
    p = [int(x) for x in pubs]
    if not p:
        raise ValueError("empty keccak publics")
    n = p[0]
    if len(p) != 1 + 200 * n:
        raise ValueError("bad keccak publics length")
    return [p[1 + 2 * i] | (p[2 + 2 * i] << 16) for i in range(100 * n)]
