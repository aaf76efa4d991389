"""SHA-256 compression accelerator circuit: prove batches of
compression-function applications.

TPU-native replacement for the reference guest's patched `sha2` crate
(SURVEY.md §2.1 guest crypto patches — compressions route to a
precompile circuit via syscall). Same accelerator shape as
circuits/keccak.py: the executor records (state, block) -> state'
claims; batches are proven standalone and linked to the main proof by
an IO RLC (resolve).

Trace layout: each compression occupies a 66-row block — rows 0..63
hold the working state at the START of round t plus the 16-word message
schedule window W_t..W_{t+15}; row 64 holds the post-round-63 state and
the committed digest (init + state, the FIPS 180-4 feed-forward); row 65
pads the block. Columns (all bits):

  s[8][32]     working state a..h
  w[16][32]    schedule window (row t, slot j = W_{t+j}; row 0 = block)
  init[8][32]  the block's input state, propagated through the block
  t1[32]+carr  T1 = h + S1(e) + Ch(e,f,g) + K_t + W_t, 16-bit halves
               with small carry bits (field-overflow-safe, the same
               half-sum discipline as the rv32im ALU)
  dig[8][32]   output row: init + state mod 2^32 (per-word carries)
  act          block carries a claimed compression (bound to publics)

Round function as constraints (degree <= 4): per-bit XOR trees for
S0/S1/s0/s1 (xor3 expansion, degree 3), Ch/Maj as quadratic/cubic bit
expressions, and word-level half-sums for T1 / new_a / new_e / schedule
expansion. K_t enters through control value columns (klo/khi), gated by
the round-active control bit.

Port note: a jax-free copy of ``zeth_tpu.circuits.sha256``. The AIR is
unchanged; the derived challenge is computed in bulk
(``hostmath.ext_rlc``, the same value as the reference's loop),
``prove_batch`` runs on the port's prover on `device` (None: the CUDA
card), and ``claims_digest`` hashes on `device` too. The recursion hooks
(``publics_shape``, ``derived_challenges_rec``) come from
``circuits.resolve``.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..hash.sha256 import _K, IV
from ..zkp import proof as proof_mod
from ..zkp import prover as prover_mod
from ..zkp import verifier as verifier_mod
from ..zkp.air import Air
from .resolve import LimbStreamResolve

ROWS_PER_COMP = 66
ROUNDS = 64

# main column offsets (all bits)
S_OFF = 0                       # 8 x 32
W_OFF = S_OFF + 8 * 32          # 16 x 32
INIT_OFF = W_OFF + 16 * 32      # 8 x 32
T1_OFF = INIT_OFF + 8 * 32      # 32
T1C_LO = T1_OFF + 32            # 3
T1C_HI = T1C_LO + 3             # 3
NAC_LO = T1C_HI + 3             # 2
NAC_HI = NAC_LO + 2             # 2
NEC_LO = NAC_HI + 2             # 1
NEC_HI = NEC_LO + 1             # 1
WXC_LO = NEC_HI + 1             # 2
WXC_HI = WXC_LO + 2             # 2
DIG_OFF = WXC_HI + 2            # 8 x 32
DC_OFF = DIG_OFF + 8 * 32       # 8 x 2 (lo, hi carry per word)
ACT_COL = DC_OFF + 16
N_MAIN = ACT_COL + 1

# control columns
CT_ISF, CT_ISL, CT_INPUT, CT_OUTPUT, CT_BLK_LAST, CT_ACTIVE = range(6)
CT_KLO, CT_KHI = 6, 7
N_CONTROL = 8


def _s_col(word: int, z: int) -> int:
    return S_OFF + word * 32 + z


def _w_col(j: int, z: int) -> int:
    return W_OFF + j * 32 + z


class Sha256Air(LimbStreamResolve, Air):
    """Batch of SHA-256 compressions, 66 rows each."""

    name = "sha256-compress"
    control_cols = N_CONTROL
    main_cols = N_MAIN
    aux_cols = 4                  # the IO RLC chain
    n_challenges = 1              # gamma
    n_derived = 1                 # expected RLC of the public IO limbs
    n_public_scalars = 0
    main_bit_mask = np.ones(N_MAIN, dtype=bool)

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        r = np.arange(n) % ROWS_PER_COMP
        full = (np.arange(n) // ROWS_PER_COMP) \
            < (n // ROWS_PER_COMP)           # complete blocks only
        cols[:, CT_INPUT] = (r == 0) & full
        cols[:, CT_ACTIVE] = (r < ROUNDS) & full
        cols[:, CT_OUTPUT] = (r == ROUNDS) & full
        cols[:, CT_BLK_LAST] = (r == ROWS_PER_COMP - 1) & full
        k = np.where(r < ROUNDS, _K[np.minimum(r, ROUNDS - 1)], 0)
        cols[:, CT_KLO] = (k & 0xFFFF) * cols[:, CT_ACTIVE]
        cols[:, CT_KHI] = (k >> 16) * cols[:, CT_ACTIVE]
        cols[0, CT_ISF] = 1
        cols[-1, CT_ISL] = 1
        return cols

    # -- IO binding --------------------------------------------------------

    def derived_challenges(self, publics, challenges, extra=None):
        """RLC of the public limb stream, sum_i limb_i gamma^(L-1-i)."""
        limbs = parse_publics(publics, flat_limbs=True)
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        return H.ext_rlc(limbs, gamma)[None, :]

    def build_aux(self, main_std, challenges):
        main_std = np.asarray(main_std, np.uint64)
        n = main_std.shape[0]
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        g48 = H.ext_pow(gamma, 48)
        g16 = H.ext_pow(gamma, 16)
        gp48 = H.ext_powers(gamma, 48)[::-1]
        gp16 = H.ext_powers(gamma, 16)[::-1]
        weights = (np.uint64(1) << np.arange(16, dtype=np.uint64))

        def limbs_of(row, off, nwords):
            bits = main_std[row, off:off + nwords * 32].reshape(nwords, 2, 16)
            return (bits * weights[None, None, :]).sum(axis=2).reshape(-1)

        r_mod = np.arange(n) % ROWS_PER_COMP
        act = main_std[:, ACT_COL] == 1
        col = np.zeros((n, 4), dtype=np.uint64)
        r = np.zeros(4, dtype=np.uint64)
        for i in range(n):
            if act[i] and r_mod[i] == 0:
                limbs = np.concatenate([limbs_of(i, S_OFF, 8),
                                        limbs_of(i, W_OFF, 16)])
                acc = ((gp48 * limbs[:, None]) % H.PU).sum(axis=0) % H.PU
                r = H.ext_add(H.ext_mul(r, g48), acc)
            elif act[i] and r_mod[i] == ROUNDS:
                limbs = limbs_of(i, DIG_OFF, 8)
                acc = ((gp16 * limbs[:, None]) % H.PU).sum(axis=0) % H.PU
                r = H.ext_add(H.ext_mul(r, g16), acc)
            col[i] = r
        return col

    # -- witgen ------------------------------------------------------------

    @staticmethod
    def witgen(states: np.ndarray, blocks: np.ndarray, po2: int
               ) -> tuple[np.ndarray, list]:
        """states: (nc, 8) uint32-valued state words, blocks: (nc, 16)
        words -> (main_std (n, cols), publics)."""
        n = 1 << po2
        n_real = states.shape[0]
        full = n // ROWS_PER_COMP
        assert n_real <= full
        states = np.concatenate(
            [np.asarray(states, np.uint64),
             np.zeros((full - n_real, 8), np.uint64)])
        blocks = np.concatenate(
            [np.asarray(blocks, np.uint64),
             np.zeros((full - n_real, 16), np.uint64)])
        nc = full
        m = np.zeros((n, N_MAIN), dtype=np.uint8)
        for c in range(n_real):
            m[c * ROWS_PER_COMP:(c + 1) * ROWS_PER_COMP, ACT_COL] = 1

        M32 = np.uint64(0xFFFFFFFF)
        rotr = lambda v, k: ((v >> np.uint64(k))
                             | (v << np.uint64(32 - k))) & M32

        def put_bits(rows, off, words, nbits=32):
            for wi in range(words.shape[1]):
                for z in range(nbits):
                    m[rows, off + wi * nbits + z] = \
                        (words[:, wi] >> np.uint64(z)) & np.uint64(1)

        # init columns: constant through the block
        for r0 in range(ROWS_PER_COMP):
            put_bits(np.arange(nc) * ROWS_PER_COMP + r0, INIT_OFF, states)

        s = states.copy()                     # (nc, 8) a..h
        w = blocks.copy()                     # (nc, 16) window
        for t in range(ROUNDS + 1):
            rows = np.arange(nc) * ROWS_PER_COMP + t
            put_bits(rows, S_OFF, s)
            put_bits(rows, W_OFF, w)
            if t == ROUNDS:
                break
            a, b, c, d, e, f, g, h = (s[:, i] for i in range(8))
            S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
            ch = (e & f) ^ (~e & g & M32)
            t1_full = h + S1 + ch + np.uint64(int(_K[t])) + w[:, 0]
            t1 = t1_full & M32
            # carries of the two 16-bit halves
            lo_sum = ((h & np.uint64(0xFFFF)) + (S1 & np.uint64(0xFFFF))
                      + (ch & np.uint64(0xFFFF))
                      + np.uint64(int(_K[t]) & 0xFFFF)
                      + (w[:, 0] & np.uint64(0xFFFF)))
            c_lo = lo_sum >> np.uint64(16)
            hi_sum = ((h >> np.uint64(16)) + (S1 >> np.uint64(16))
                      + (ch >> np.uint64(16))
                      + np.uint64(int(_K[t]) >> 16)
                      + (w[:, 0] >> np.uint64(16)) + c_lo)
            c_hi = hi_sum >> np.uint64(16)
            for z in range(3):
                m[rows, T1C_LO + z] = (c_lo >> np.uint64(z)) & np.uint64(1)
                m[rows, T1C_HI + z] = (c_hi >> np.uint64(z)) & np.uint64(1)
            put_bits(rows, T1_OFF, t1[:, None])
            S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            na_full = t1 + S0 + maj
            na = na_full & M32
            na_lo = ((t1 & np.uint64(0xFFFF)) + (S0 & np.uint64(0xFFFF))
                     + (maj & np.uint64(0xFFFF)))
            nac_lo = na_lo >> np.uint64(16)
            na_hi = ((t1 >> np.uint64(16)) + (S0 >> np.uint64(16))
                     + (maj >> np.uint64(16)) + nac_lo)
            nac_hi = na_hi >> np.uint64(16)
            ne_full = d + t1
            ne = ne_full & M32
            ne_lo = (d & np.uint64(0xFFFF)) + (t1 & np.uint64(0xFFFF))
            nec_lo = ne_lo >> np.uint64(16)
            ne_hi = (d >> np.uint64(16)) + (t1 >> np.uint64(16)) + nec_lo
            nec_hi = ne_hi >> np.uint64(16)
            for z in range(2):
                m[rows, NAC_LO + z] = (nac_lo >> np.uint64(z)) & np.uint64(1)
                m[rows, NAC_HI + z] = (nac_hi >> np.uint64(z)) & np.uint64(1)
            m[rows, NEC_LO] = nec_lo & np.uint64(1)
            m[rows, NEC_HI] = nec_hi & np.uint64(1)
            # schedule expansion
            w1, w14 = w[:, 1], w[:, 14]
            s0 = rotr(w1, 7) ^ rotr(w1, 18) ^ (w1 >> np.uint64(3))
            s1 = rotr(w14, 17) ^ rotr(w14, 19) ^ (w14 >> np.uint64(10))
            wn_full = w[:, 0] + s0 + w[:, 9] + s1
            wn = wn_full & M32
            wx_lo = ((w[:, 0] & np.uint64(0xFFFF)) + (s0 & np.uint64(0xFFFF))
                     + (w[:, 9] & np.uint64(0xFFFF))
                     + (s1 & np.uint64(0xFFFF)))
            wxc_lo = wx_lo >> np.uint64(16)
            wx_hi = ((w[:, 0] >> np.uint64(16)) + (s0 >> np.uint64(16))
                     + (w[:, 9] >> np.uint64(16)) + (s1 >> np.uint64(16))
                     + wxc_lo)
            wxc_hi = wx_hi >> np.uint64(16)
            for z in range(2):
                m[rows, WXC_LO + z] = (wxc_lo >> np.uint64(z)) & np.uint64(1)
                m[rows, WXC_HI + z] = (wxc_hi >> np.uint64(z)) & np.uint64(1)
            s = np.stack([na, a, b, c, ne, e, f, g], axis=1)
            w = np.concatenate([w[:, 1:], wn[:, None]], axis=1)

        # output row: digest = init + state (feed-forward)
        out_rows = np.arange(nc) * ROWS_PER_COMP + ROUNDS
        dig = (states + s) & M32
        put_bits(out_rows, DIG_OFF, dig)
        for wi in range(8):
            lo = (states[:, wi] & np.uint64(0xFFFF)) \
                + (s[:, wi] & np.uint64(0xFFFF))
            dlo = lo >> np.uint64(16)
            hi = (states[:, wi] >> np.uint64(16)) \
                + (s[:, wi] >> np.uint64(16)) + dlo
            dhi = hi >> np.uint64(16)
            m[out_rows, DC_OFF + 2 * wi] = dlo & np.uint64(1)
            m[out_rows, DC_OFF + 2 * wi + 1] = dhi & np.uint64(1)

        publics = [n_real]
        for c in range(n_real):
            for word in list(states[c]) + list(blocks[c]) + list(dig[c]):
                publics += [int(word) & 0xFFFF, int(word) >> 16]
        return m.astype(np.uint64), publics

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        from ..zkp.air import cadd, cext, cmul, cmul_base, csub
        add, sub, mul = ops.add, ops.sub, ops.mul
        one = ops.const(1)
        two = ops.const(2)
        cs = []

        def boolc(e):
            return mul(e, sub(e, one))

        def x2(u, w):
            return sub(add(u, w), mul(two, mul(u, w)))

        act = v("main", ACT_COL)
        isf = v("control", CT_ISF)
        isl = v("control", CT_ISL)
        is_input = v("control", CT_INPUT)
        is_output = v("control", CT_OUTPUT)
        blk_last = v("control", CT_BLK_LAST)
        rnd = v("control", CT_ACTIVE)
        not_last = sub(one, isl)

        for j in range(N_MAIN):
            cs.append(boolc(v("main", j)))

        # bit helpers (current row / next row)
        sb = lambda wi, z, o=0: v("main", _s_col(wi, z), o)
        wb = lambda j, z, o=0: v("main", _w_col(j, z), o)

        A, B, C, D, E, F, G, Hh = range(8)

        def half(bitf, lo):
            """sum_z 2^z bitf(z) over a 16-bit half."""
            r = range(0, 16) if lo else range(16, 32)
            acc = None
            for z in r:
                t = mul(ops.const(1 << (z % 16)), bitf(z))
                acc = t if acc is None else add(acc, t)
            return acc

        def s1_bit(z):
            return x2(x2(sb(E, (z + 6) % 32), sb(E, (z + 11) % 32)),
                      sb(E, (z + 25) % 32))

        def ch_bit(z):
            e, f, g = sb(E, z), sb(F, z), sb(G, z)
            return add(mul(e, f), mul(sub(one, e), g))

        def s0_bit(z):
            return x2(x2(sb(A, (z + 2) % 32), sb(A, (z + 13) % 32)),
                      sb(A, (z + 22) % 32))

        def maj_bit(z):
            a, b, c = sb(A, z), sb(B, z), sb(C, z)
            ab = mul(a, b)
            return sub(add(ab, add(mul(b, c), mul(a, c))),
                       mul(two, mul(ab, c)))

        def carr(off, nb, base=0):
            acc = None
            for z in range(nb):
                t = mul(ops.const(1 << z), v("main", off + z))
                acc = t if acc is None else add(acc, t)
            return acc

        # T1 half-sums (gated by rnd)
        klo, khi = v("control", CT_KLO), v("control", CT_KHI)
        t1c_lo = carr(T1C_LO, 3)
        t1c_hi = carr(T1C_HI, 3)
        t1_lo = half(lambda z: v("main", T1_OFF + z), True)
        t1_hi = half(lambda z: v("main", T1_OFF + z), False)
        lhs_lo = add(add(half(lambda z: sb(Hh, z), True),
                         half(s1_bit, True)),
                     add(half(ch_bit, True),
                         add(klo, half(lambda z: wb(0, z), True))))
        cs.append(mul(rnd, sub(lhs_lo,
                               add(t1_lo, mul(ops.const(1 << 16), t1c_lo)))))
        lhs_hi = add(add(half(lambda z: sb(Hh, z), False),
                         half(s1_bit, False)),
                     add(half(ch_bit, False),
                         add(khi, add(half(lambda z: wb(0, z), False),
                                      t1c_lo))))
        cs.append(mul(rnd, sub(lhs_hi,
                               add(t1_hi, mul(ops.const(1 << 16), t1c_hi)))))

        # new_a = T1 + S0 + Maj  (next-row a)
        nac_lo = carr(NAC_LO, 2)
        nac_hi = carr(NAC_HI, 2)
        na_lo = half(lambda z: sb(A, z, 1), True)
        na_hi = half(lambda z: sb(A, z, 1), False)
        cs.append(mul(rnd, sub(add(t1_lo, add(half(s0_bit, True),
                                              half(maj_bit, True))),
                               add(na_lo, mul(ops.const(1 << 16), nac_lo)))))
        cs.append(mul(rnd, sub(add(t1_hi, add(half(s0_bit, False),
                                              add(half(maj_bit, False),
                                                  nac_lo))),
                               add(na_hi, mul(ops.const(1 << 16), nac_hi)))))

        # new_e = D + T1  (next-row e)
        nec_lo = v("main", NEC_LO)
        nec_hi = v("main", NEC_HI)
        ne_lo = half(lambda z: sb(E, z, 1), True)
        ne_hi = half(lambda z: sb(E, z, 1), False)
        cs.append(mul(rnd, sub(add(half(lambda z: sb(D, z), True), t1_lo),
                               add(ne_lo, mul(ops.const(1 << 16), nec_lo)))))
        cs.append(mul(rnd, sub(add(half(lambda z: sb(D, z), False),
                                   add(t1_hi, nec_lo)),
                               add(ne_hi, mul(ops.const(1 << 16), nec_hi)))))

        # state shifts: b' = a, c' = b, d' = c, f' = e, g' = f, h' = g
        for dst, src in ((B, A), (C, B), (D, C), (F, E), (G, F), (Hh, G)):
            for z in range(32):
                cs.append(mul(rnd, sub(sb(dst, z, 1), sb(src, z))))

        # window shift + expansion
        for j in range(15):
            for z in range(32):
                cs.append(mul(rnd, sub(wb(j, z, 1), wb(j + 1, z))))

        def sig0_bit(z):
            r = x2(wb(1, (z + 7) % 32), wb(1, (z + 18) % 32))
            if z + 3 < 32:
                return x2(r, wb(1, z + 3))
            return r

        def sig1_bit(z):
            r = x2(wb(14, (z + 17) % 32), wb(14, (z + 19) % 32))
            if z + 10 < 32:
                return x2(r, wb(14, z + 10))
            return r

        wxc_lo = carr(WXC_LO, 2)
        wxc_hi = carr(WXC_HI, 2)
        wn_lo = half(lambda z: wb(15, z, 1), True)
        wn_hi = half(lambda z: wb(15, z, 1), False)
        cs.append(mul(rnd, sub(
            add(add(half(lambda z: wb(0, z), True), half(sig0_bit, True)),
                add(half(lambda z: wb(9, z), True), half(sig1_bit, True))),
            add(wn_lo, mul(ops.const(1 << 16), wxc_lo)))))
        cs.append(mul(rnd, sub(
            add(add(half(lambda z: wb(0, z), False), half(sig0_bit, False)),
                add(half(lambda z: wb(9, z), False),
                    add(half(sig1_bit, False), wxc_lo))),
            add(wn_hi, mul(ops.const(1 << 16), wxc_hi)))))

        # init: bound to the input row's state; constant through the block
        for wi in range(8):
            for z in range(32):
                ic = v("main", INIT_OFF + wi * 32 + z)
                cs.append(mul(is_input, sub(ic, sb(wi, z))))
                # not_last: the trace is cyclic; the tail's final row
                # (blk_last = 0) must not constrain the wrap to row 0
                cs.append(mul(mul(sub(one, blk_last), not_last),
                              sub(v("main", INIT_OFF + wi * 32 + z, 1), ic)))

        # digest feed-forward on the output row
        for wi in range(8):
            ini_lo = half(lambda z: v("main", INIT_OFF + wi * 32 + z), True)
            ini_hi = half(lambda z: v("main", INIT_OFF + wi * 32 + z), False)
            st_lo = half(lambda z: sb(wi, z), True)
            st_hi = half(lambda z: sb(wi, z), False)
            dg_lo = half(lambda z: v("main", DIG_OFF + wi * 32 + z), True)
            dg_hi = half(lambda z: v("main", DIG_OFF + wi * 32 + z), False)
            dlo = v("main", DC_OFF + 2 * wi)
            dhi = v("main", DC_OFF + 2 * wi + 1)
            cs.append(mul(is_output, sub(add(ini_lo, st_lo),
                                         add(dg_lo,
                                             mul(ops.const(1 << 16), dlo)))))
            cs.append(mul(is_output, sub(add(ini_hi, add(st_hi, dlo)),
                                         add(dg_hi,
                                             mul(ops.const(1 << 16), dhi)))))

        # act constant within a block (not_last: cyclic wrap, as above)
        cs.append(mul(mul(sub(one, blk_last), not_last),
                      sub(v("main", ACT_COL, 1), act)))

        # --- IO RLC binding ----------------------------------------------
        gamma = challenges[0]
        d_rlc = challenges[1]
        gpow = [cext(ops, 1)]
        for _ in range(48):
            gpow.append(cmul(ops, gpow[-1], gamma))

        def lin48(row_off=0):
            acc = None
            j = 0
            for wi in range(8):
                for lo in (True, False):
                    t = cmul_base(ops, gpow[47 - j],
                                  half(lambda z: sb(wi, z, row_off), lo))
                    acc = t if acc is None else cadd(ops, acc, t)
                    j += 1
            for wj in range(16):
                for lo in (True, False):
                    t = cmul_base(ops, gpow[47 - j],
                                  half(lambda z: wb(wj, z, row_off), lo))
                    acc = t if acc is None else cadd(ops, acc, t)
                    j += 1
            return acc

        def lin16(row_off=0):
            acc = None
            j = 0
            for wi in range(8):
                for lo in (True, False):
                    t = cmul_base(ops, gpow[15 - j],
                                  half(lambda z: v("main",
                                                   DIG_OFF + wi * 32 + z,
                                                   row_off), lo))
                    acc = t if acc is None else cadd(ops, acc, t)
                    j += 1
            return acc

        r = tuple(v("aux", c) for c in range(4))
        rn = tuple(v("aux", c, 1) for c in range(4))
        first_val = cmul_base(ops, lin48(), mul(act, is_input))
        cs.extend(cmul_base(ops, csub(ops, r, first_val), isf))
        act_in_n = mul(v("main", ACT_COL, 1), v("control", CT_INPUT, 1))
        act_out_n = mul(v("main", ACT_COL, 1), v("control", CT_OUTPUT, 1))
        step_in = csub(ops, rn, cadd(ops, cmul(ops, r, gpow[48]), lin48(1)))
        g16c = gpow[16]
        step_out = csub(ops, rn, cadd(ops, cmul(ops, r, g16c), lin16(1)))
        keep = csub(ops, rn, r)
        mix = cadd(ops, cmul_base(ops, step_in, act_in_n),
                   cadd(ops, cmul_base(ops, step_out, act_out_n),
                        cmul_base(ops, keep,
                                  sub(one, add(act_in_n, act_out_n)))))
        cs.extend(cmul_base(ops, mix, not_last))
        cs.extend(cmul_base(ops, csub(ops, r, d_rlc), isl))
        return cs


def parse_publics(pubs, flat_limbs: bool = False):
    """Decode the public IO: [nc, then per compression 32 words as
    (lo16, hi16) limb pairs: 8 state-in, 16 block, 8 state-out]."""
    p = [int(x) for x in pubs]
    if not p:
        raise ValueError("empty sha256 publics")
    nc = p[0]
    if len(p) != 1 + 64 * nc:
        raise ValueError("bad sha256 publics length")
    if any(x < 0 or x >= (1 << 16) for x in p[1:]):
        raise ValueError("sha256 limb out of range")
    if flat_limbs:
        return p[1:]
    out = []
    for i in range(nc):
        off = 1 + 64 * i
        words = [p[off + 2 * j] | (p[off + 2 * j + 1] << 16)
                 for j in range(32)]
        out.append((words[:8], words[8:24], words[24:32]))
    return out


def claims_digest(io: list[tuple], device=None) -> np.ndarray:
    """Poseidon2 digest over the proof-bound IO limb stream, hashed on
    `device` (None: the CUDA card)."""
    limbs = []
    for st, blk, out in io:
        for w in st + blk + out:
            limbs += [w & 0xFFFF, w >> 16]
    return P2.sponge_row(np.asarray(limbs, np.uint64), device)


def choose_po2(nc: int) -> int:
    need = max(nc * ROWS_PER_COMP, 128)
    return int(np.ceil(np.log2(need)))


def prove_batch(states: np.ndarray, blocks: np.ndarray, device=None):
    """Prove a batch of compressions on `device` (None: the CUDA card;
    without one the call raises); returns (seal, claims digest)."""
    device = resolve_device(device)
    air = Sha256Air()
    po2 = choose_po2(len(states))
    with prover_mod._Stage("sha witgen (host)", device):
        main, publics = Sha256Air.witgen(states, blocks, po2)
    pf = prover_mod.prove(air, main, publics, device=device)
    with prover_mod._Stage("claims digest", device):
        digest = claims_digest(parse_publics(pf.publics), device)
    return proof_mod.encode(pf), digest


def verify_batch(seal, device=None) -> list[tuple]:
    """Verify an accelerator seal (the control root on `device`, None: the
    CUDA card); returns the proof-bound (state_in, block, state_out)
    claims."""
    pf = proof_mod.decode(seal)
    verifier_mod.verify(Sha256Air(), pf, pf.publics, device=device)
    return parse_publics(pf.publics)
