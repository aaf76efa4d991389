"""Frozen copy of ``zeth_tpu_torch/circuits/paging.py`` (the paging AIR: its
layout, control trace, publics, derived challenges and constraints; no
witness generation); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..hostmath import P
from ..hash import pagetree as PT
from ..hash import poseidon2 as P2
from ..zkp.air import Air, cadd, cext, cmul, cmul_base, csub


PU = np.uint64(P)
CELLS = P2.CELLS

SLOT_ROWS = 864
N_BLOCKS = 54
N_DATA_BLOCKS = 32
DEPTH = PT.DEPTH                  # 22 path blocks
BLOCK_ROWS = 16

# block phases
PH_AB = (0, 1, 2, 3)
PH_ME = 4
PH_RE = (5, 6, 7, 8, 12, 13, 14, 15)
PH_RI = (9, 10, 11)

LEAF_TAG = PT.LEAF_TAG
NODE_TAG = PT.NODE_TAG


# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------


class _Layout:
    def __init__(self):
        self.n = 0
        self.slices: dict[str, slice] = {}
        for name, width in [
            ("sp", CELLS), ("sq", CELLS),     # pre / post sponge states
            ("xp", CELLS), ("xq", CELLS),     # sbox intermediates
            ("sib", 8),                       # level sibling digest
            ("root", 8),                      # running root
            ("pg", DEPTH),                    # page index bits
            ("wp0", 32), ("wp1", 32),         # pre words (this absorb row)
            ("wq0", 32), ("wq1", 32),         # post words
            ("tp0", 1), ("tp1", 1),           # touched flags
            ("act", 1),                       # slot-active flag
        ]:
            self.slices[name] = slice(self.n, self.n + width)
            self.n += width

    def idx(self, name, k=0):
        s = self.slices[name]
        assert s.start + k < s.stop
        return s.start + k


LAYOUT = _Layout()

_VALUE_COLS = ("sp", "sq", "xp", "xq", "sib", "root")


def _main_bit_mask():
    mask = np.ones(LAYOUT.n, dtype=bool)
    for name in _VALUE_COLS:
        mask[LAYOUT.slices[name]] = False
    return mask


# control columns
C_ISF, C_ISL = 0, 1
C_DAB = 2                  # 4 one-hot data-absorb phases
C_PAB = C_DAB + 4          # path-inject row (block AB phase 0)
C_HOLD = C_PAB + 1         # identity-transition rows (path AB phases 1-3)
C_ME = C_HOLD + 1
C_RE = C_ME + 1
C_RI = C_RE + 1
C_RC = C_RI + 1            # 24 round-constant columns
C_LVL = C_RC + CELLS       # 22 one-hot level columns (path-inject rows)
C_OFF = C_LVL + DEPTH      # word offset of this absorb row's word 0
C_SEND = C_OFF + 1         # slot-end rows (last row of block 53)
C_FRESH = C_SEND + 1       # leaf-sponge start rows (block 0, phase 0)
C_DAT = C_FRESH + 1        # data-absorb rows (any phase)
N_CONTROL = C_DAT + 1


def _perm_row_schedule():
    """(kind, rc(24)) per block phase 4..15. kind: 0=ME, 1=RE, 2=RI."""
    c = P2.constants()
    rc_ext, rc_int = c["rc_ext"], c["rc_int"]
    rows = [(0, np.zeros(CELLS, np.uint64))]
    for r in range(4):
        rows.append((1, rc_ext[r].astype(np.uint64)))
    for j in range(3):
        rc = np.zeros(CELLS, np.uint64)
        rc[:7] = rc_int[7 * j:7 * j + 7]
        rows.append((2, rc))
    for r in range(4, 8):
        rows.append((1, rc_ext[r].astype(np.uint64)))
    return rows


class PagingAir(Air):
    """One cached instance covers every segment (control depends only on
    po2, so the constraint tape and control roots are shared)."""

    name = "paging"
    control_cols = N_CONTROL
    main_cols = LAYOUT.n
    aux_cols = 24            # TP0 TP1 TQ0 TQ1 acc0 acc1 (ext each)
    main_bit_mask = _main_bit_mask()
    n_challenges = 0
    n_derived = 2            # g4, g5 recomposed from the publics
    n_public_scalars = 64

    # -- publics helpers ---------------------------------------------------

    @staticmethod
    def parse_publics(pubs):
        p = [int(x) for x in pubs]
        if len(p) != 64:
            raise ValueError("paging publics must have 64 limbs")
        if any(x < 0 or x >= (1 << 16) for x in p):
            raise ValueError("paging public limb out of 16-bit range")
        vals = [p[2 * i] | (p[2 * i + 1] << 16) for i in range(32)]
        if any(v >= P for v in vals):
            raise ValueError("paging public element out of field range")
        return {
            "g4": np.array(vals[0:4], np.uint64),
            "g5": np.array(vals[4:8], np.uint64),
            "pre_root": np.array(vals[8:16], np.uint64),
            "post_root": np.array(vals[16:24], np.uint64),
            "d0": np.array(vals[24:28], np.uint64),
            "d1": np.array(vals[28:32], np.uint64),
        }

    def derived_challenges(self, publics, challenges, extra=None):
        pp = self.parse_publics(publics)
        return np.stack([pp["g4"], pp["g5"]])

    # -- recursion-circuit hooks ------------------------------------------

    # lift claims bind this proof's main root, so the rv32im lift claim's
    # paging-root binding pins the exact paging STARK that was lifted
    bind_claim_main_root = True

    # -- control -----------------------------------------------------------

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        cols[0, C_ISF] = 1
        cols[-1, C_ISL] = 1
        n_slots = n // SLOT_ROWS
        assert n_slots * SLOT_ROWS < n, "power-of-two trace always has tail"
        perm = _perm_row_schedule()
        # one slot template, tiled
        t = np.zeros((SLOT_ROWS, N_CONTROL), dtype=np.uint64)
        for b in range(N_BLOCKS):
            r0 = b * BLOCK_ROWS
            if b < N_DATA_BLOCKS:
                for a in range(4):
                    t[r0 + a, C_DAB + a] = 1
                    t[r0 + a, C_DAT] = 1
                    t[r0 + a, C_OFF] = b * 8 + a * 2
            else:
                t[r0, C_PAB] = 1
                t[r0, C_LVL + (b - N_DATA_BLOCKS)] = 1
                t[r0 + 1:r0 + 4, C_HOLD] = 1
            for ph in range(4, 16):
                kind, rc = perm[ph - 4]
                row = r0 + ph
                t[row, (C_ME, C_RE, C_RI)[kind]] = 1
                t[row, C_RC:C_RC + CELLS] = rc
        t[0, C_FRESH] = 1
        t[SLOT_ROWS - 1, C_SEND] = 1
        if n_slots:
            cols[:n_slots * SLOT_ROWS, :] = np.tile(t, (n_slots, 1))
        cols[0, C_ISF] = 1       # re-assert (tile wrote row 0)
        return cols

    # -- witgen ------------------------------------------------------------

    # -- aux ---------------------------------------------------------------

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        L = LAYOUT
        one = ops.const(1)
        add, sub, mul = ops.add, ops.sub, ops.mul

        def m(name, k=0, off=0):
            return v("main", L.idx(name, k), off)

        def ctl(k, off=0):
            return v("control", k, off)

        def aux(k, off=0):
            return tuple(v("aux", 4 * k + c, off) for c in range(4))

        def lin(pairs):
            acc = None
            for coeff, e in pairs:
                t = e if coeff == 1 else mul(ops.const(coeff), e)
                acc = t if acc is None else add(acc, t)
            return acc if acc is not None else ops.const(0)

        cs = []
        isf, isl = ctl(C_ISF), ctl(C_ISL)
        not_last = sub(one, isl)

        # --- booleanity ---------------------------------------------------
        for name in ("pg", "wp0", "wp1", "wq0", "wq1", "tp0", "tp1", "act"):
            s = L.slices[name]
            for k in range(s.stop - s.start):
                b = m(name, k)
                cs.append(mul(b, sub(b, one)))

        # --- sponge state chains ------------------------------------------
        rc = [ctl(C_RC + i) for i in range(CELLS)]
        mu = P2.constants()["diag"]

        def ext_layer(z):
            """M_E = per-4-block M4 then add block sums (poseidon2.py)."""
            out = []
            M4 = np.asarray(P2._M4, np.uint64)
            blk = []
            for b in range(CELLS // 4):
                rowvals = []
                for i in range(4):
                    rowvals.append(lin(
                        [(int(M4[i][j]), z[4 * b + j]) for j in range(4)]))
                blk.append(rowvals)
            ssum = [None] * 4
            for b in range(CELLS // 4):
                for i in range(4):
                    ssum[i] = blk[b][i] if ssum[i] is None else \
                        add(ssum[i], blk[b][i])
            for b in range(CELLS // 4):
                for i in range(4):
                    out.append(add(blk[b][i], ssum[i]))
            return out

        def cube(x):
            return mul(mul(x, x), x)

        for sname, xname in (("sp", "xp"), ("sq", "xq")):
            st = [m(sname, i) for i in range(CELLS)]
            st1 = [m(sname, i, 1) for i in range(CELLS)]
            x3 = [m(xname, i) for i in range(CELLS)]

            chain = [ops.const(0)] * CELLS

            def chain_add(sel_t, exprs, chain=chain):
                for i in range(CELLS):
                    chain[i] = add(chain[i],
                                   mul(sel_t, sub(st1[i], exprs[i])))

            # ME row: st' = M_E(st)
            chain_add(ctl(C_ME), ext_layer(st))
            # RE row: t = st + rc; x3 = t^3; st' = M_E(x3^2 t)
            t_ext = [add(st[i], rc[i]) for i in range(CELLS)]
            for i in range(CELLS):
                cs.append(mul(ctl(C_RE), sub(x3[i], cube(t_ext[i]))))
            x7 = [mul(mul(x3[i], x3[i]), t_ext[i]) for i in range(CELLS)]
            chain_add(ctl(C_RE), ext_layer(x7))
            # RI row: 7 packed internal rounds (recursion/vm.py schedule)
            s_prev = list(st)
            for r in range(1, 8):
                if r == 1:
                    x_in = add(st[0], rc[0])
                else:
                    x_in = x3[6 + r - 1]
                    cs.append(mul(ctl(C_RI),
                                  sub(x_in, add(s_prev[0], rc[r - 1]))))
                u = x3[r - 1]
                cs.append(mul(ctl(C_RI), sub(u, cube(x_in))))
                x7r = mul(mul(u, u), x_in)
                cells = [x7r] + s_prev[1:]
                ssum = cells[0]
                for c in cells[1:]:
                    ssum = add(ssum, c)
                s_prev = [add(ssum, mul(ops.const(int((int(mu[i]) - 1) % P)),
                                        cells[i]))
                          for i in range(CELLS)]
            chain_add(ctl(C_RI), s_prev)
            # hold rows (path absorb phases 1-3): st' = st
            chain_add(ctl(C_HOLD), st)

            # data absorb rows: st' = base + inject
            fresh = ctl(C_FRESH)
            w0, w1 = ((("wp0", "wp1") if sname == "sp" else ("wq0", "wq1")))
            lo0 = lin([(1 << j, m(w0, j)) for j in range(16)])
            hi0 = lin([(1 << (j - 16), m(w0, j)) for j in range(16, 32)])
            lo1 = lin([(1 << j, m(w1, j)) for j in range(16)])
            hi1 = lin([(1 << (j - 16), m(w1, j)) for j in range(16, 32)])
            limbs = [lo0, hi0, lo1, hi1]
            for a in range(4):
                sel_a = ctl(C_DAB + a)
                exprs = []
                for i in range(CELLS):
                    if a == 0:
                        base = add(sub(st[i], mul(fresh, st[i])),
                                   mul(fresh, ops.const(
                                       LEAF_TAG if i == 16 else 0)))
                    else:
                        base = st[i]
                    if 4 * a <= i < 4 * a + 4:
                        base = add(base, limbs[i - 4 * a])
                    exprs.append(base)
                chain_add(sel_a, exprs)

            # path inject rows: st' = node-tag state + ordered digests
            dirb = lin([(1, mul(ctl(C_LVL + k2), m("pg", k2)))
                        for k2 in range(DEPTH)])
            exprs = []
            for i in range(CELLS):
                if i < 8:
                    x, y = st[i], m("sib", i)
                    e = add(mul(dirb, y), sub(x, mul(dirb, x)))
                elif i < 16:
                    x, y = st[i - 8], m("sib", i - 8)
                    e = add(mul(dirb, x), sub(y, mul(dirb, y)))
                elif i == 16:
                    e = ops.const(NODE_TAG)
                else:
                    e = ops.const(0)
                exprs.append(e)
            chain_add(ctl(C_PAB), exprs)

            cs.extend(mul(not_last, c) for c in chain)

        # --- root chain ---------------------------------------------------
        act = m("act")
        send = ctl(C_SEND)
        for i in range(8):
            root_i, root_n = m("root", i), m("root", i, 1)
            # hold everywhere except across slot ends
            cs.append(mul(mul(not_last, sub(one, send)),
                          sub(root_n, root_i)))
            # at slot end: recomputed pre-root must match, root updates
            cs.append(mul(mul(send, act), sub(m("sp", i, 1), root_i)))
            cs.append(mul(mul(send, not_last),
                          sub(root_n, add(mul(act, m("sq", i, 1)),
                                          sub(root_i,
                                              mul(act, root_i))))))
        # publics binding
        for i in range(8):
            pre_i = add(publics[16 + 2 * i],
                        mul(ops.const(1 << 16), publics[16 + 2 * i + 1]))
            post_i = add(publics[32 + 2 * i],
                         mul(ops.const(1 << 16), publics[32 + 2 * i + 1]))
            cs.append(mul(isf, sub(m("root", i), pre_i)))
            cs.append(mul(isl, sub(m("root", i), post_i)))

        # --- slot-constant columns ----------------------------------------
        hold_gate = mul(not_last, sub(one, send))
        for j in range(DEPTH):
            cs.append(mul(hold_gate, sub(m("pg", j, 1), m("pg", j))))
        cs.append(mul(hold_gate, sub(m("act", 0, 1), act)))
        # active slots form a prefix
        cs.append(mul(mul(send, sub(one, act)), m("act", 0, 1)))

        # --- touched-word LogUp sums (g4/g5 from publics) ------------------
        g4 = challenges[0]
        g5 = challenges[1]
        g5sq = cmul(ops, g5, g5)
        pgval = lin([(1 << j, m("pg", j)) for j in range(DEPTH)])
        dat = ctl(C_DAT)
        for t, (wname, qname, tname, slot_p, slot_q) in enumerate(
                (("wp0", "wq0", "tp0", 0, 2), ("wp1", "wq1", "tp1", 1, 3))):
            tch = m(tname)
            # touch flags only on data rows of active slots
            cs.append(mul(tch, sub(one, dat)))
            cs.append(mul(tch, sub(one, act)))
            wa = add(mul(ops.const(PT.PAGE_WORDS), pgval),
                     add(ctl(C_OFF), ops.const(t)))
            for wn, slot in ((wname, slot_p), (qname, slot_q)):
                lo = lin([(1 << j, m(wn, j)) for j in range(16)])
                hi = lin([(1 << (j - 16), m(wn, j)) for j in range(16, 32)])
                fp = cadd(ops, cext(ops, wa),
                          cadd(ops, cmul_base(ops, g5, lo),
                               cmul_base(ops, g5sq, hi)))
                cs.extend(csub(ops,
                               cmul(ops, csub(ops, g4, fp), aux(slot)),
                               cext(ops, tch)))
            # untouched words: post == pre (limb level)
            qlo = lin([(1 << j, m(qname, j)) for j in range(16)])
            qhi = lin([(1 << (j - 16), m(qname, j)) for j in range(16, 32)])
            plo = lin([(1 << j, m(wname, j)) for j in range(16)])
            phi = lin([(1 << (j - 16), m(wname, j)) for j in range(16, 32)])
            keep = mul(dat, sub(one, tch))
            cs.append(mul(keep, sub(qlo, plo)))
            cs.append(mul(keep, sub(qhi, phi)))

        # accumulators
        def dsum(slots, off=0):
            d = aux(slots[0], off)
            for s in slots[1:]:
                d = cadd(ops, d, aux(s, off))
            return d

        for accslot, slots, pub_off in ((4, (0, 1), 48), (5, (2, 3), 56)):
            acc = aux(accslot)
            cs.extend(cmul_base(ops, csub(ops, acc, dsum(slots)), isf))
            cs.extend(cmul_base(
                ops,
                csub(ops, aux(accslot, 1), cadd(ops, acc, dsum(slots, 1))),
                not_last))
            dpub = tuple(
                add(publics[pub_off + 2 * c],
                    mul(ops.const(1 << 16), publics[pub_off + 2 * c + 1]))
                for c in range(4))
            cs.extend(cmul_base(ops, csub(ops, acc, dpub), isl))

        return cs
