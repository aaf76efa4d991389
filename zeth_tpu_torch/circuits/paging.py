"""Paging AIR: in-circuit Poseidon2 page hashing + Merkle root update.

Proves, for one rv32im segment, that the segment's RAM-argument boundary
lists are consistent with the Merkle-committed memory image
(hash/pagetree.py): starting from the public ``pre_root``, every touched
page's pre-contents hash to a leaf on a verified sibling path, the
post-contents (pre with the touched words replaced) re-hash along the
SAME siblings into the running root, and the final root equals the
public ``post_root``. The touched (addr, value) pairs are accumulated as
the LogUp sums

    d0 = sum 1/(g4 - (wa + g5*pre_lo + g5^2*pre_hi))   (MEMINIT side)
    d1 = sum 1/(g4 - (wa + g5*post_lo + g5^2*post_hi)) (MEMFIN side)

under the rv32im proof's RAM-argument challenges g4/g5 (public inputs
here), so the rv32im circuit's MEMINIT/MEMFIN boundary binding (derived
scalars d0/d1, circuits/rv32im.py) discharges against a memory image
digest instead of a public word list. This replaces the role of the
reference's in-trace page hashing (risc0-circuit-rv32im paging groups,
SURVEY.md §2.2; same 1 KiB page granularity) with a TPU-first factoring:
the irregular CPU circuit stays narrow, and the dense, regular hashing
work lands in this fully periodic companion circuit (vectorized witgen,
one cached constraint tape for every segment shape).

Challenge-ordering note: the rv32im transcript must absorb this proof's
main-trace root BEFORE sampling g4/g5 (prover.prove(extra_mix=...)), so
the page/touch witness is committed before the challenges it is summed
under exist — the standard LogUp soundness ordering.

Layout: one 864-row slot per touched page = 54 blocks of 16 rows.
Blocks 0..31 absorb the page data (dual sponge: pre-page into sp,
post-page into sq; 4 absorb rows of 2+2 words, then the 12-row
permutation). Blocks 32..53 are the 22 tree levels: one block per level,
pre and post compressions running in the two sponges over the SHARED
sibling, order selected by the page-index bit (the path's direction
bits ARE the committed page index). Permutation row schedule (one
external round per row, internal rounds packed 7-per-row) follows
recursion/vm.py.

Publics (64 scalars, 16-bit limb pairs lo,hi):
  [0:8]   g4   (4 components x 2 limbs)
  [8:16]  g5
  [16:32] pre_root  (8 cells x 2 limbs)
  [32:48] post_root
  [48:56] d0   (4 components x 2 limbs)
  [56:64] d1
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
    def pack_publics(g4, g5, pre_root, post_root, d0, d1) -> list[int]:
        out = []
        for vec in (g4, g5):
            for c in np.asarray(vec, np.uint64).reshape(4):
                out += [int(c) & 0xFFFF, int(c) >> 16]
        for vec in (pre_root, post_root):
            for c in np.asarray(vec, np.uint64).reshape(8):
                out += [int(c) & 0xFFFF, int(c) >> 16]
        for vec in (d0, d1):
            for c in np.asarray(vec, np.uint64).reshape(4):
                out += [int(c) & 0xFFFF, int(c) >> 16]
        return out

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

    def publics_shape(self, publics):
        return None

    def derived_challenges_rec(self, b, pub_cells, chal_ext, pub_shape):
        """In-circuit mirror of derived_challenges: recompose g4/g5 from
        the 16-bit limb pairs of the publics (the claim binds the raw
        cells; the host's canonical parse enforces limb ranges)."""
        out = []
        for base in (0, 8):
            comps = [b.axpy(1 << 16, pub_cells[base + 2 * i + 1],
                            pub_cells[base + 2 * i]) for i in range(4)]
            out.append(b.combine_ext(comps))
        return out

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

    @staticmethod
    def witgen(pnums, pre_pages, post_pages, touched, sibs, pre_root,
               post_root, g4, g5, po2=None):
        """Build (main_std, publics) for a batch of touched pages.

        pnums: (k,) page indices (any order; root update is sequential).
        pre_pages/post_pages: (k, 256) words. touched: (k, 256) bool.
        sibs: (k, DEPTH, 8) sibling digests along each page's path,
        valid for the running root at that page's turn (host: pagetree
        paths are identical for all pages of one segment batch because
        sibling nodes shared with other touched pages are recomputed;
        use segment_witness() to build these correctly).
        """
        k = len(pnums)
        n = 1 << (po2 if po2 is not None
                  else max(int(np.ceil(np.log2(k * SLOT_ROWS + 1))), 11))
        assert k * SLOT_ROWS < n
        L = LAYOUT
        m = np.zeros((n, L.n), dtype=np.uint64)

        pre_pages = np.asarray(pre_pages, np.uint64).reshape(k, PT.PAGE_WORDS)
        post_pages = np.asarray(post_pages, np.uint64).reshape(
            k, PT.PAGE_WORDS)
        touched = np.asarray(touched, bool).reshape(k, PT.PAGE_WORDS)
        pnums = np.asarray(pnums, np.uint64).reshape(k)
        sibs = np.asarray(sibs, np.uint64).reshape(k, DEPTH, 8)

        # fill one simulated slot for (batch of) pages; returns the full
        # carried-out sponge states (the chain constraints pin them onto
        # the next region's first row)
        def fill(rows_sel, pages_pre, pages_post, pn, sb):
            """rows_sel: (kk,) slot start rows. Vectorized over kk."""
            kk = len(rows_sel)
            limbs_p = np.empty((kk, PT.PAGE_LIMBS), np.uint64)
            limbs_p[:, 0::2] = pages_pre & np.uint64(0xFFFF)
            limbs_p[:, 1::2] = pages_pre >> np.uint64(16)
            limbs_q = np.empty((kk, PT.PAGE_LIMBS), np.uint64)
            limbs_q[:, 0::2] = pages_post & np.uint64(0xFFFF)
            limbs_q[:, 1::2] = pages_post >> np.uint64(16)

            sp = np.zeros((kk, CELLS), np.uint64)
            sq = np.zeros((kk, CELLS), np.uint64)
            perm = _perm_row_schedule()

            def put_state(rows, sp_v, sq_v):
                m[rows, L.slices["sp"].start:L.slices["sp"].stop] = sp_v
                m[rows, L.slices["sq"].start:L.slices["sq"].stop] = sq_v

            def run_perm(r0):
                """Emit rows r0+4..r0+15 and the x3 columns; states are
                read/updated in place (sp/sq nonlocal arrays)."""
                nonlocal sp, sq
                for ph in range(4, 16):
                    rows = rows_sel + r0 + ph
                    put_state(rows, sp, sq)
                    kind, rc = perm[ph - 4]
                    if kind == 0:
                        sp = _ext_np(sp)
                        sq = _ext_np(sq)
                    elif kind == 1:
                        for nmx, st in (("xp", sp), ("xq", sq)):
                            tv = (st + rc[None]) % PU
                            x3 = H.fmul(H.fmul(tv, tv), tv)
                            m[rows, L.slices[nmx].start:
                              L.slices[nmx].stop] = x3
                        sp = _ext_np(_x7_np(sp, rc))
                        sq = _ext_np(_x7_np(sq, rc))
                    else:
                        sp, x3p = _rint_np(sp, rc)
                        sq, x3q = _rint_np(sq, rc)
                        m[rows, L.slices["xp"].start:
                          L.slices["xp"].stop] = x3p
                        m[rows, L.slices["xq"].start:
                          L.slices["xq"].stop] = x3q

            # data blocks
            for b in range(N_DATA_BLOCKS):
                r0 = b * BLOCK_ROWS
                for a in range(4):
                    rows = rows_sel + r0 + a
                    put_state(rows, sp, sq)
                    lo = b * 16 + a * 4
                    if b == 0 and a == 0:
                        sp = np.zeros_like(sp)
                        sq = np.zeros_like(sq)
                        sp[:, 16] = LEAF_TAG
                        sq[:, 16] = LEAF_TAG
                    sp[:, 4 * a:4 * a + 4] = (
                        sp[:, 4 * a:4 * a + 4]
                        + limbs_p[:, lo:lo + 4]) % PU
                    sq[:, 4 * a:4 * a + 4] = (
                        sq[:, 4 * a:4 * a + 4]
                        + limbs_q[:, lo:lo + 4]) % PU
                run_perm(r0)
            # path blocks
            for lvl in range(DEPTH):
                r0 = (N_DATA_BLOCKS + lvl) * BLOCK_ROWS
                rows = rows_sel + r0
                put_state(rows, sp, sq)
                m[rows, L.slices["sib"].start:L.slices["sib"].stop] = \
                    sb[:, lvl]
                d = ((pn >> np.uint64(lvl)) & np.uint64(1)).astype(bool)
                cur_p, cur_q = sp[:, :8].copy(), sq[:, :8].copy()
                sibv = sb[:, lvl]
                sp = np.zeros_like(sp)
                sq = np.zeros_like(sq)
                sp[:, 16] = NODE_TAG
                sq[:, 16] = NODE_TAG
                sp[:, 0:8] = np.where(d[:, None], sibv, cur_p)
                sp[:, 8:16] = np.where(d[:, None], cur_p, sibv)
                sq[:, 0:8] = np.where(d[:, None], sibv, cur_q)
                sq[:, 8:16] = np.where(d[:, None], cur_q, sibv)
                for ph in range(1, 4):
                    put_state(rows_sel + r0 + ph, sp, sq)
                run_perm(r0)
            # final carried-out states (the chain constraint at the last
            # perm row pins them onto the next region's first row)
            return sp.copy(), sq.copy()

        # active slots: sequential root chain (but states vectorize
        # across pages since only root/sib depend on order)
        roots = np.empty((k + 1, 8), np.uint64)
        roots[0] = np.asarray(pre_root, np.uint64)
        slot_starts = np.arange(k, dtype=np.int64) * SLOT_ROWS
        sp_sl = L.slices["sp"]
        sq_sl = L.slices["sq"]
        if k:
            out_p, out_q = fill(slot_starts, pre_pages, post_pages,
                                pnums, sibs)
            for i in range(k):
                roots[i + 1] = out_q[i, :8]
            # carry each slot's output state onto the next slot's row 0
            m[slot_starts[1:], sp_sl.start:sp_sl.stop] = out_p[:-1]
            m[slot_starts[1:], sq_sl.start:sq_sl.stop] = out_q[:-1]
            carry_p, carry_q = out_p[-1], out_q[-1]
        else:
            carry_p = carry_q = np.zeros(CELLS, np.uint64)
        # inactive slots: zero-page template
        n_slots = n // SLOT_ROWS
        n_inactive = n_slots - k
        if n_inactive > 0:
            zp = np.zeros((1, PT.PAGE_WORDS), np.uint64)
            zs = np.zeros((1, DEPTH, 8), np.uint64)
            z = PT.zero_digests()
            for lvl in range(DEPTH):
                zs[0, lvl] = z[lvl]
            t0 = k * SLOT_ROWS
            zout_p, zout_q = fill(np.array([t0], np.int64), zp, zp,
                                  np.zeros(1, np.uint64), zs)
            # carry in from the last active slot (or leave free at row 0)
            if k:
                m[t0, sp_sl.start:sp_sl.stop] = carry_p
                m[t0, sq_sl.start:sq_sl.stop] = carry_q
            # the remaining inactive slots are identical, with the
            # zero-slot's own output carried between them
            template = m[t0:t0 + SLOT_ROWS].copy()
            template[0, sp_sl.start:sp_sl.stop] = zout_p[0]
            template[0, sq_sl.start:sq_sl.stop] = zout_q[0]
            for j in range(1, n_inactive):
                m[t0 + j * SLOT_ROWS:t0 + (j + 1) * SLOT_ROWS] = template
            carry_p, carry_q = zout_p[0], zout_q[0]
        # tail first row receives the final carry
        m[n_slots * SLOT_ROWS, sp_sl.start:sp_sl.stop] = carry_p
        m[n_slots * SLOT_ROWS, sq_sl.start:sq_sl.stop] = carry_q

        # per-slot constants: pg bits, act, root
        for i in range(k):
            sl = slice(i * SLOT_ROWS, (i + 1) * SLOT_ROWS)
            for j in range(DEPTH):
                m[sl, L.idx("pg", j)] = (int(pnums[i]) >> j) & 1
            m[sl, L.idx("act")] = 1
            m[sl, L.slices["root"].start:L.slices["root"].stop] = roots[i]
        m[k * SLOT_ROWS:, L.slices["root"].start:L.slices["root"].stop] = \
            roots[k]

        # word bits + touch flags on data absorb rows
        for b in range(N_DATA_BLOCKS):
            for a in range(4):
                off = b * 8 + a * 2
                rows = slot_starts + b * BLOCK_ROWS + a
                if k == 0:
                    break
                for t, wname, qname, tname in (
                        (0, "wp0", "wq0", "tp0"), (1, "wp1", "wq1", "tp1")):
                    wpre = pre_pages[:, off + t]
                    wpost = post_pages[:, off + t]
                    for j in range(32):
                        m[rows, L.idx(wname, j)] = (
                            wpre >> np.uint64(j)) & np.uint64(1)
                        m[rows, L.idx(qname, j)] = (
                            wpost >> np.uint64(j)) & np.uint64(1)
                    m[rows, L.idx(tname)] = touched[:, off + t]

        # publics: d0/d1 sums over touched words
        d0 = _touch_sum(pnums, pre_pages, touched, g4, g5)
        d1 = _touch_sum(pnums, post_pages, touched, g4, g5)
        publics = PagingAir.pack_publics(g4, g5, roots[0], post_root,
                                         d0, d1)
        assert (np.asarray(post_root, np.uint64) == roots[k]).all(), \
            "claimed post_root does not match the replayed update chain"
        return m, publics

    # -- aux ---------------------------------------------------------------

    def build_aux(self, main_std, challenges):
        g4 = H.ext(np.asarray(challenges[0], np.uint64))
        g5 = H.ext(np.asarray(challenges[1], np.uint64))
        main_std = np.asarray(main_std, np.uint64)
        n = main_std.shape[0]
        L = LAYOUT
        ctrl = self.control_trace(int(np.log2(n)))

        def bits(name, lo, hi):
            s = L.slices[name]
            out = np.zeros(n, dtype=np.uint64)
            for j in range(lo, hi):
                out += main_std[:, s.start + j] << np.uint64(j - lo)
            return out

        pgval = np.zeros(n, dtype=np.uint64)
        for j in range(DEPTH):
            pgval += main_std[:, L.idx("pg", j)] << np.uint64(j)
        off = ctrl[:, C_OFF]
        g5p = H.ext_powers(g5, 3)

        def term(wname, tname, t):
            lo, hi = bits(wname, 0, 16), bits(wname, 16, 32)
            wa = (pgval * np.uint64(PT.PAGE_WORDS) + off + np.uint64(t)) % PU
            fp = ((wa[:, None] * g5p[0][None]
                   + lo[:, None] * g5p[1][None]
                   + hi[:, None] * g5p[2][None]) % PU)
            inv = H.ext_inv((g4[None] + PU - fp % PU) % PU)
            act = main_std[:, L.idx(tname)]
            return act[:, None] * inv % PU

        tp0 = term("wp0", "tp0", 0)
        tp1 = term("wp1", "tp1", 1)
        tq0 = term("wq0", "tp0", 0)
        tq1 = term("wq1", "tp1", 1)
        acc0 = np.cumsum((tp0 + tp1) % PU, axis=0) % PU
        acc1 = np.cumsum((tq0 + tq1) % PU, axis=0) % PU
        aux = np.concatenate([tp0, tp1, tq0, tq1, acc0, acc1], axis=1)
        assert aux.shape == (n, self.aux_cols)
        return aux

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


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def _ext_np(st):
    """(k, 24) external linear layer."""
    return P2._external_np(st.T).T


def _x7_np(st, rc):
    tv = (st + rc[None]) % PU
    x3 = H.fmul(H.fmul(tv, tv), tv)
    return H.fmul(H.fmul(x3, x3), tv)


def _rint_np(st, rc):
    """7 packed internal rounds; returns (state', x3cols (k, 24))."""
    k = st.shape[0]
    x3cols = np.zeros((k, CELLS), np.uint64)
    mu = P2.constants()["diag"]
    s_prev = st.copy()
    for r in range(1, 8):
        x = (s_prev[:, 0] + rc[r - 1]) % PU
        if r >= 2:
            x3cols[:, 6 + r - 1] = x
        u = H.fmul(H.fmul(x, x), x)
        x3cols[:, r - 1] = u
        x7 = H.fmul(u, H.fmul(u, x))
        cells = s_prev.copy()
        cells[:, 0] = x7
        ssum = cells.sum(axis=1) % PU
        s_prev = (ssum[:, None] + H.fmul((mu[None] - 1) % PU, cells)) % PU
    return s_prev, x3cols


def _touch_sum(pnums, pages, touched, g4, g5):
    """d = sum over touched words of 1/(g4 - (wa + g5 lo + g5^2 hi))."""
    g4e = H.ext(np.asarray(g4, np.uint64))
    g5p = H.ext_powers(H.ext(np.asarray(g5, np.uint64)), 3)
    ks, offs = np.nonzero(np.asarray(touched, bool))
    if len(ks) == 0:
        return np.zeros(4, np.uint64)
    wa = (np.asarray(pnums, np.uint64)[ks] * np.uint64(PT.PAGE_WORDS)
          + offs.astype(np.uint64))
    vals = np.asarray(pages, np.uint64)[ks, offs]
    fp = ((wa % PU)[:, None] * g5p[0][None]
          + (vals & np.uint64(0xFFFF))[:, None] * g5p[1][None]
          + (vals >> np.uint64(16))[:, None] * g5p[2][None]) % PU
    inv = H.ext_inv((g4e[None] + PU - fp % PU) % PU)
    return inv.sum(axis=0) % PU


def segment_witness(tree, mem_addrs, mem_pre, mem_post):
    """Build the paging witness for one segment from the pre-state tree.

    tree: SparsePageTree at SEGMENT ENTRY (will be mutated to the
    segment-exit state). mem_addrs/mem_pre/mem_post: the segment's RAM
    boundary lists (byte addrs, word values) — exactly the rv32im
    MEMINIT/MEMFIN content.

    Returns (pnums, pre_pages, post_pages, touched, sibs, pre_root,
    post_root). Sibling paths are taken per page AT ITS TURN in the
    sorted update order, matching the in-circuit sequential root chain.
    """
    mem_addrs = np.asarray(mem_addrs, np.uint64)
    mem_pre = np.asarray(mem_pre, np.uint64)
    mem_post = np.asarray(mem_post, np.uint64)
    pre_root = tree.root()
    pn_of = (mem_addrs >> np.uint64(PT.PAGE_BITS)).astype(np.int64)
    pnums = sorted(set(int(p) for p in pn_of))
    k = len(pnums)
    pre_pages = np.zeros((k, PT.PAGE_WORDS), np.uint64)
    post_pages = np.zeros((k, PT.PAGE_WORDS), np.uint64)
    touched = np.zeros((k, PT.PAGE_WORDS), bool)
    sibs = np.zeros((k, DEPTH, 8), np.uint64)
    for i, pn in enumerate(pnums):
        pre_pages[i] = tree.page_words(pn)
        sel = pn_of == pn
        offs = ((mem_addrs[sel] >> np.uint64(2))
                & np.uint64(PT.PAGE_WORDS - 1)).astype(np.int64)
        # consistency: claimed pre values match the tree
        assert (pre_pages[i][offs] == mem_pre[sel]).all(), \
            "segment MEMINIT values disagree with the page tree"
        post = pre_pages[i].copy()
        post[offs] = mem_post[sel]
        post_pages[i] = post
        touched[i, offs] = True
        # sibling path at this page's turn, then apply the update
        _, s = tree.paths([pn])
        sibs[i] = s[0]
        for off, w in zip(offs, mem_post[sel]):
            tree.set_word((pn << PT.PAGE_BITS) | (int(off) << 2), int(w))
    post_root = tree.root()
    return (np.array(pnums, np.uint64), pre_pages, post_pages, touched,
            sibs, pre_root, post_root)
