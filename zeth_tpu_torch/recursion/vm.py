"""Recursion VM: a straight-line write-once-memory AIR for in-circuit
STARK verification.

Replaces the role of risc0-circuit-recursion 4.0.2 (SURVEY.md §2.2): "a
small VM for verifying STARKs in-circuit" running the lift/join/resolve
programs. The reference's recursion circuit is an unmounted pinned crate;
this design is original and TPU-first:

- The *program* is the control group: every row's opcode selectors,
  memory addresses, read multiplicities, round constants / immediates and
  scalar coefficients are control columns, deterministic per program.
  The existing control-root check (zkp/verifier.py) therefore pins the
  full program, exactly as it pins the rv32im ROM.
- Data lives in a **write-once memory** (WOM) of F_p4 cells. Each row
  makes up to 9 accesses whose addresses and multiplicities are fixed by
  the program; consistency is a LogUp argument over (addr, value)
  fingerprints with full F_p4 challenges. Because every address is
  written by exactly one program row and addresses/multiplicities are
  control-determined, the dataflow graph is a DAG fixed by the program —
  the prover's only freedom is the witness input stream (the inner seal).
- One universal arithmetic row (FMA2: ``out = s0·a·b + s1·c·d + s2·e +
  imm`` over F_p4) plus Poseidon2 permutation rows (1 external round per
  row, all 21 internal rounds packed into 3 rows of 7) keep the trace
  narrow (~200 columns) and the row count ~O(verifier work).

The verifier-program compiler lives in recursion/builder.py; witgen is a
sequential interpreter (C++ in executor/csrc/recvm.cpp).

Port note: a jax-free copy of ``zeth_tpu.recursion.vm``. The program, the
layouts, the control trace, the host LogUp ``build_aux`` and the
constraints are unchanged. ``RecursionAir.witgen`` runs the native
interpreter only and lets its errors through (a failed build or load
raises with the compiler's output); ``_witgen_py`` stays as the plain
reference that the tests hold the native interpreter equal to.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import hostmath as H
from ..hash import poseidon2 as P2
from ..hostmath import P
from ..zkp.air import Air, cadd, cext, cmul, cmul_base, csub

PU = np.uint64(P)

# ---------------------------------------------------------------------------
# Row types
# ---------------------------------------------------------------------------

(T_FMA, T_IN, T_BIT, T_ASSERT, T_PUB, T_INIT, T_REXT, T_RINT,
 T_ABSLO, T_ABSHI, T_SEL0, T_SEL4, T_DIG, T_DIGHI) = range(14)
N_TYPES = 14
T_NOP = 255

N_SLOTS = 9          # WOM access slots per row
N_PUB = 8            # outer publics bound by pub_sel columns
CELLS = P2.CELLS     # 24

# witness-function tags for T_IN rows (how witgen produces the value)
WF_STREAM = 0        # next element of the input stream (base field)
WF_INV = 1           # base inverse of m[src].c0
WF_BITOF = 2         # bit k of m[src].c0
WF_EXTINV = 3        # component k of the F_p4 inverse of m[src]
WF_COMPOF = 4        # component k of m[src] (bound via combine_ext assert)

# ---------------------------------------------------------------------------
# Column layout
# ---------------------------------------------------------------------------


class _CL:
    """Control column indices."""
    SEL = 0                       # 14 selector columns
    ADDR = SEL + N_TYPES          # 9 address columns
    MULT = ADDR + N_SLOTS         # 9 multiplicity columns (field elements)
    RC = MULT + N_SLOTS           # 24 round-constant / immediate columns
    S = RC + CELLS                # 3 scalar coefficient columns (s0,s1,s2)
    PUBSEL = S + 3                # 8 public-binding selector columns
    FRESH = PUBSEL + N_PUB        # absorb-into-zero-state flag
    ISF = FRESH + 1
    ISL = ISF + 1
    N = ISL + 1                   # 70


class _ML:
    """Main column indices."""
    VAL = 0                       # 9 slots x 4 components
    ST = VAL + 4 * N_SLOTS        # 24 Poseidon state cells
    X3 = ST + CELLS               # 24 sbox intermediate cells
    N = X3 + CELLS                # 84


class _AL:
    """Aux column indices."""
    INV = 0                       # 9 slots x 4 (LogUp inverse helpers)
    ACC = INV + 4 * N_SLOTS       # 4 (running LogUp sum)
    N = ACC + 4                   # 40


CL, ML, AL = _CL, _ML, _AL


# ---------------------------------------------------------------------------
# Program representation
# ---------------------------------------------------------------------------


@dataclass
class Program:
    """A straight-line recursion program (the control group content).

    All arrays are parallel over program rows. WOM cell 0 always holds 1
    (written by a bootstrap row the builder emits first).
    """
    typ: np.ndarray          # (n,) uint16 row type (T_NOP for padding)
    addr: np.ndarray         # (n, 9) int64 cell addresses (0 if unused)
    mult: np.ndarray         # (n, 9) uint32 LogUp multiplicity coefficients
    rc: np.ndarray           # (n, 24) uint32 round constants / immediates
    s: np.ndarray            # (n, 3) uint32 FMA scalar coefficients
    pub: np.ndarray          # (n,) int16 public index bound by a T_PUB row (-1)
    wf: np.ndarray           # (n, 3) int64 witness-fn: [tag, src, k]
    n_cells: int             # WOM size
    n_stream: int            # required witness stream length

    @property
    def n_rows(self) -> int:
        return int(self.typ.shape[0])

    def po2(self) -> int:
        """Smallest trace po2 that fits the program (+1 padding row)."""
        return max(4, int(self.n_rows + 1 - 1).bit_length())

    def digest(self) -> bytes:
        """Identity of the program (for caching control roots)."""
        import hashlib
        h = hashlib.sha256()
        for a in (self.typ, self.addr, self.mult, self.rc, self.s,
                  self.pub, self.wf):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()


# ---------------------------------------------------------------------------
# The AIR
# ---------------------------------------------------------------------------


def _mu() -> np.ndarray:
    return P2.constants()["diag"]


class RecursionAir(Air):
    """AIR over one Program. Registered per program (like the rv32im AIR
    per guest image); the control root pins the program."""

    control_cols = CL.N
    main_cols = ML.N
    aux_cols = AL.N
    n_challenges = 2             # gamma (fingerprint), delta (value RLC)
    n_derived = 0
    n_public_scalars = N_PUB

    def __init__(self, program: Program):
        self.program = program
        self.name = f"recvm-{program.digest().hex()[:16]}"

    # -- control ----------------------------------------------------------

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        pr = self.program
        assert pr.n_rows < n, "program does not fit the trace (needs padding)"
        m = np.zeros((n, CL.N), dtype=np.uint64)
        r = pr.n_rows
        typ = pr.typ.astype(np.int64)
        for t in range(N_TYPES):
            m[:r, CL.SEL + t] = (typ == t).astype(np.uint64)
        m[:r, CL.ADDR:CL.ADDR + N_SLOTS] = pr.addr.astype(np.uint64)
        m[:r, CL.MULT:CL.MULT + N_SLOTS] = pr.mult.astype(np.uint64)
        m[:r, CL.RC:CL.RC + CELLS] = pr.rc.astype(np.uint64)
        m[:r, CL.S:CL.S + 3] = pr.s.astype(np.uint64)
        pubrows = np.nonzero(pr.pub >= 0)[0]
        for i in pubrows:
            m[i, CL.PUBSEL + int(pr.pub[i])] = 1
        # fresh flag rides wf[ , 2] for state rows (builder convention)
        is_state = ((typ == T_ABSLO) | (typ == T_ABSHI)
                    | (typ == T_SEL0) | (typ == T_SEL4))
        m[:r, CL.FRESH] = np.where(is_state, pr.wf[:, 2], 0).astype(np.uint64)
        m[0, CL.ISF] = 1
        m[n - 1, CL.ISL] = 1
        return m

    # -- aux (LogUp) ------------------------------------------------------

    def build_aux(self, main_std: np.ndarray, challenges: np.ndarray):
        pr = self.program
        n = main_std.shape[0]
        gamma = np.asarray(challenges[0], np.uint64) % PU
        delta = np.asarray(challenges[1], np.uint64) % PU
        dp = H.ext_powers(delta, 5)          # delta^1..delta^4 at [1..4]

        def base_ext(a):
            # explicit base->ext embed (H.ext misparses length-4 vectors)
            out = np.zeros(a.shape + (4,), dtype=np.uint64)
            out[..., 0] = a % PU
            return out

        aux = np.zeros((n, AL.N), dtype=np.uint64)
        r = pr.n_rows
        vals = main_std[:r, ML.VAL:ML.VAL + 4 * N_SLOTS].reshape(r, N_SLOTS, 4)
        addr = pr.addr.astype(np.uint64)
        mult = pr.mult.astype(np.uint64)
        terms = np.zeros((n, 4), dtype=np.uint64)
        for s in range(N_SLOTS):
            active = mult[:, s] != 0
            if not active.any():
                continue
            v = vals[active, s, :]
            fp = base_ext(addr[active, s])
            for c in range(4):
                fp = H.ext_add(fp, H.ext_mul(dp[c + 1], base_ext(v[:, c])))
            phi = H.ext_sub(np.broadcast_to(gamma, fp.shape), fp)
            inv = H.ext_inv(phi)
            block = np.zeros((r, 4), dtype=np.uint64)
            block[active] = inv
            aux[:r, AL.INV + 4 * s:AL.INV + 4 * s + 4] = block
            t = np.zeros((r, 4), dtype=np.uint64)
            t[active] = H.ext_mul(inv, base_ext(mult[active, s]))
            terms[:r] = H.ext_add(terms[:r], t)
        acc = np.cumsum(terms, axis=0, dtype=np.uint64) % PU
        aux[:, AL.ACC:AL.ACC + 4] = acc
        # honest witgen always cancels (every write carries -#reads); a
        # nonzero tail is caught by the isl*acc constraint, not here, so
        # forged traces still produce a (failing) aux for tamper tests
        return aux

    # -- constraints ------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        add, sub, mul = ops.add, ops.sub, ops.mul
        one = ops.const(1)

        def ctl(col, off=0):
            return v("control", col, off)

        def mn(col, off=0):
            return v("main", col, off)

        def ax(col, off=0):
            return v("aux", col, off)

        sel = [ctl(CL.SEL + t) for t in range(N_TYPES)]
        rc = [ctl(CL.RC + i) for i in range(CELLS)]
        st = [mn(ML.ST + i) for i in range(CELLS)]
        st1 = [mn(ML.ST + i, 1) for i in range(CELLS)]
        x3 = [mn(ML.X3 + i) for i in range(CELLS)]
        val = [[mn(ML.VAL + 4 * s + c) for c in range(4)]
               for s in range(N_SLOTS)]
        fresh = ctl(CL.FRESH)
        isf, isl = ctl(CL.ISF), ctl(CL.ISL)
        mu = [int(x) for x in _mu()]

        cs = []

        # ---- external linear layer (symbolic) ----------------------------
        def m4_block(cells4):
            out = []
            for i in range(4):
                acc = None
                for j in range(4):
                    term = mul(ops.const(int(P2._M4[i][j]) % P), cells4[j])
                    acc = term if acc is None else add(acc, term)
                out.append(acc)
            return out

        def ext_layer(cells):
            z = []
            for b in range(CELLS // 4):
                z += m4_block(cells[4 * b:4 * b + 4])
            ssum = list(z[0:4])
            for b in range(1, CELLS // 4):
                for i in range(4):
                    ssum[i] = add(ssum[i], z[4 * b + i])
            return [add(z[i], ssum[i % 4]) for i in range(CELLS)]

        def cube(x):
            return mul(mul(x, x), x)

        # ---- next-state definitions per row type -------------------------
        # The chain constraint per state cell i is the selector-weighted
        # sum of (st'_i - expr_{type,i}); one-hot selectors make each
        # active term vanish independently.
        chain = [ops.const(0)] * CELLS

        def chain_add(sel_t, exprs):
            for i in range(CELLS):
                chain[i] = add(chain[i], mul(sel_t, sub(st1[i], exprs[i])))

        # INIT: st' = M_E(st + rc)
        chain_add(sel[T_INIT], ext_layer([add(st[i], rc[i])
                                          for i in range(CELLS)]))

        # REXT: t = st + rc; x3 = t^3 (committed); st' = M_E(x3^2 t)
        t_ext = [add(st[i], rc[i]) for i in range(CELLS)]
        for i in range(CELLS):
            cs.append(mul(sel[T_REXT], sub(x3[i], cube(t_ext[i]))))
        x7 = [mul(mul(x3[i], x3[i]), t_ext[i]) for i in range(CELLS)]
        chain_add(sel[T_REXT], ext_layer(x7))

        # RINT: 7 packed internal rounds. u_r = x3[r-1] (sbox^3 commit),
        # w_r = x3[6+r-1] (sbox input commit, rounds 2..7).
        s_prev = list(st)
        for r in range(1, 8):
            if r == 1:
                x_in = add(st[0], rc[0])
            else:
                x_in = x3[6 + r - 1]
                cs.append(mul(sel[T_RINT],
                              sub(x_in, add(s_prev[0], rc[r - 1]))))
            u = x3[r - 1]
            cs.append(mul(sel[T_RINT], sub(u, cube(x_in))))
            x7r = mul(mul(u, u), x_in)
            cells = [x7r] + s_prev[1:]
            ssum = cells[0]
            for c in cells[1:]:
                ssum = add(ssum, c)
            s_prev = [add(ssum, mul(ops.const((mu[i] - 1) % P), cells[i]))
                      for i in range(CELLS)]
        chain_add(sel[T_RINT], s_prev)

        # ABSORB_LO / ABSORB_HI: st' = (1-fresh)st + rc + window(vals)
        def absorb_expr(window_lo):
            out = []
            for i in range(CELLS):
                base = add(sub(st[i], mul(fresh, st[i])), rc[i])
                if window_lo <= i < window_lo + 8:
                    base = add(base, val[i - window_lo][0])
                out.append(base)
            return out

        chain_add(sel[T_ABSLO], absorb_expr(0))
        chain_add(sel[T_ABSHI], absorb_expr(8))

        # SEL0 / SEL4: Merkle order-select absorb. reads: slots 0-3 = cur
        # quad x, 4-7 = sib quad y, slot 8 = direction bit b. Cells
        # j0..j0+3 get b?y:x (the "left" input), 8+j0.. get b?x:y.
        def sel_expr(j0):
            b = val[8][0]
            out = []
            for i in range(CELLS):
                base = add(sub(st[i], mul(fresh, st[i])), rc[i])
                if j0 <= i < j0 + 4:
                    x, y = val[i - j0][0], val[4 + i - j0][0]
                    base = add(base, add(mul(b, y),
                                         sub(x, mul(b, x))))
                elif 8 + j0 <= i < 8 + j0 + 4:
                    x, y = val[i - 8 - j0][0], val[4 + i - 8 - j0][0]
                    base = add(base, add(mul(b, x),
                                         sub(y, mul(b, y))))
                out.append(base)
            return out

        chain_add(sel[T_SEL0], sel_expr(0))
        chain_add(sel[T_SEL4], sel_expr(4))

        # DIG / DIGHI keep the state (so DIGHI can follow DIG)
        chain_add(sel[T_DIG], st)
        chain_add(sel[T_DIGHI], st)

        cs.extend(chain)

        # ---- write-value semantics ---------------------------------------
        # FMA2: val5 = s0*(val0 x val1) + s1*(val2 x val3) + s2*val4 + imm
        s0, s1, s2 = ctl(CL.S), ctl(CL.S + 1), ctl(CL.S + 2)
        imm = tuple(rc[i] for i in range(4))
        p01 = cmul(ops, tuple(val[0]), tuple(val[1]))
        p23 = cmul(ops, tuple(val[2]), tuple(val[3]))
        out = cadd(ops, cmul_base(ops, p01, s0), cmul_base(ops, p23, s1))
        out = cadd(ops, out, cmul_base(ops, tuple(val[4]), s2))
        out = cadd(ops, out, imm)
        for c in range(4):
            cs.append(mul(sel[T_FMA], sub(val[5][c], out[c])))

        # IN/BIT: base-field writes; BIT additionally boolean
        in_or_bit = add(sel[T_IN], sel[T_BIT])
        for c in range(1, 4):
            cs.append(mul(in_or_bit, val[5][c]))
        cs.append(mul(sel[T_BIT],
                      sub(mul(val[5][0], val[5][0]), val[5][0])))

        # ASSERT: val0 == imm (ext immediate in rc[0..3])
        for c in range(4):
            cs.append(mul(sel[T_ASSERT], sub(val[0][c], rc[c])))

        # PUB: val0.c0 == publics[j]
        for j in range(N_PUB):
            cs.append(mul(ctl(CL.PUBSEL + j), sub(val[0][0], publics[j])))

        # DIG/DIGHI: written slot values = state cells (base)
        for s in range(8):
            cs.append(add(mul(sel[T_DIG], sub(val[s][0], st[s])),
                          mul(sel[T_DIGHI], sub(val[s][0], st[8 + s]))))
            for c in range(1, 4):
                cs.append(mul(add(sel[T_DIG], sel[T_DIGHI]), val[s][c]))

        # ---- WOM LogUp ---------------------------------------------------
        gamma, delta = challenges[0], challenges[1]
        d2 = cmul(ops, delta, delta)
        d3 = cmul(ops, d2, delta)
        d4 = cmul(ops, d3, delta)
        dpow = [delta, d2, d3, d4]
        terms = None
        terms1 = None
        for s in range(N_SLOTS):
            m_s = ctl(CL.MULT + s)
            a_s = ctl(CL.ADDR + s)
            iv = tuple(ax(AL.INV + 4 * s + c) for c in range(4))
            fp = cext(ops, a_s)
            for c in range(4):
                fp = cadd(ops, fp, cmul_base(ops, dpow[c], val[s][c]))
            phi = csub(ops, gamma, fp)
            prod = cmul(ops, iv, phi)
            prod = csub(ops, prod, cext(ops, one))
            for c in range(4):
                cs.append(mul(m_s, prod[c]))
            term = cmul_base(ops, iv, m_s)
            terms = term if terms is None else cadd(ops, terms, term)
            m_s1 = ctl(CL.MULT + s, 1)
            iv1 = tuple(ax(AL.INV + 4 * s + c, 1) for c in range(4))
            term1 = cmul_base(ops, iv1, m_s1)
            terms1 = term1 if terms1 is None else cadd(ops, terms1, term1)

        acc = tuple(ax(AL.ACC + c) for c in range(4))
        acc1 = tuple(ax(AL.ACC + c, 1) for c in range(4))
        for c in range(4):
            cs.append(mul(isf, sub(acc[c], terms[c])))
            step = sub(sub(acc1[c], acc[c]), terms1[c])
            cs.append(mul(sub(one, isl), step))
            cs.append(mul(isl, acc[c]))
        return cs

    # -- witgen -----------------------------------------------------------

    def witgen(self, stream: np.ndarray, po2: int | None = None):
        """Interpret the program over the witness stream -> (main_std,
        WOM cells), with the C++ interpreter (built at first use). A
        failed build, load or run raises; nothing falls back to the
        numpy interpreter, which would take minutes per lift."""
        from . import witgen_native
        pr = self.program
        if po2 is None:
            po2 = pr.po2()
        n = 1 << po2
        assert pr.n_rows < n
        stream = np.asarray(stream, dtype=np.uint64) % PU
        assert stream.shape[0] == pr.n_stream, \
            f"stream length {stream.shape[0]} != {pr.n_stream}"
        return witgen_native.run(pr, stream, n)


# ---------------------------------------------------------------------------
# Reference witgen (numpy; the C++ interpreter must match bit-for-bit; the
# tests' plain version, not on any proving path)
# ---------------------------------------------------------------------------


def _witgen_py(pr: Program, stream: np.ndarray, n: int):
    mu = _mu().astype(np.uint64)
    main = np.zeros((n, ML.N), dtype=np.uint64)
    wom = np.zeros((pr.n_cells, 4), dtype=np.uint64)
    written = np.zeros(pr.n_cells, dtype=bool)
    st = np.zeros(CELLS, dtype=np.uint64)
    sp = 0

    def ext_mul1(a, b):
        return H.ext_mul(a, b)

    for r in range(pr.n_rows):
        t = int(pr.typ[r])
        if t == T_NOP:
            main[r + 1, ML.ST:ML.ST + CELLS] = st
            continue
        addr = pr.addr[r]
        rc = pr.rc[r].astype(np.uint64)
        vals = np.zeros((N_SLOTS, 4), dtype=np.uint64)
        # reads
        read_slots = _READ_SLOTS[t]
        for s in read_slots:
            vals[s] = wom[addr[s]]
        if t == T_FMA:
            s0, s1, s2 = (np.uint64(x) for x in pr.s[r])
            out = H.ext_mul(vals[0], vals[1]) * s0 % PU
            out = H.ext_add(out, H.ext_mul(vals[2], vals[3]) * s1 % PU)
            out = H.ext_add(out, vals[4] * s2 % PU)
            out = H.ext_add(out, rc[:4])
            vals[5] = out
            _write(wom, written, addr[5], out)
        elif t in (T_IN, T_BIT):
            tag, src, k = pr.wf[r]
            if tag == WF_STREAM:
                v = np.uint64(stream[sp]); sp += 1
            elif tag == WF_INV:
                v = H.finv(wom[src][0])
            elif tag == WF_BITOF:
                v = (wom[src][0] >> np.uint64(k)) & np.uint64(1)
            elif tag == WF_EXTINV:
                v = H.ext_inv(wom[src])[int(k)]
            elif tag == WF_COMPOF:
                v = wom[src][int(k)]
            else:
                raise AssertionError(tag)
            vals[5] = np.array([v, 0, 0, 0], dtype=np.uint64)
            _write(wom, written, addr[5], vals[5])
        elif t in (T_ASSERT, T_PUB):
            pass                    # read-only
        elif t == T_INIT:
            st = _ext_layer_np((st + rc) % PU)
        elif t == T_REXT:
            tv = (st + rc) % PU
            x3 = H.fmul(H.fmul(tv, tv), tv)
            main[r, ML.X3:ML.X3 + CELLS] = x3
            st = _ext_layer_np(H.fmul(H.fmul(x3, x3), tv))
        elif t == T_RINT:
            x3cols = np.zeros(CELLS, dtype=np.uint64)
            s_prev = st.copy()
            for rr in range(1, 8):
                x = (s_prev[0] + rc[rr - 1]) % PU
                if rr >= 2:
                    x3cols[6 + rr - 1] = x
                u = H.fmul(H.fmul(x, x), x)
                x3cols[rr - 1] = u
                x7 = H.fmul(H.fmul(u, u), x)
                cells = s_prev.copy()
                cells[0] = x7
                ssum = cells.sum() % PU
                s_prev = (ssum + H.fmul((mu - 1) % PU, cells)) % PU
            main[r, ML.X3:ML.X3 + CELLS] = x3cols
            st = s_prev
        elif t in (T_ABSLO, T_ABSHI):
            fresh = int(pr.wf[r][2])
            base = (rc if fresh else (st + rc) % PU).copy()
            lo = 0 if t == T_ABSLO else 8
            for j in range(8):
                base[lo + j] = (base[lo + j] + vals[j][0]) % PU
            st = base
        elif t in (T_SEL0, T_SEL4):
            fresh = int(pr.wf[r][2])
            base = (rc if fresh else (st + rc) % PU).copy()
            j0 = 0 if t == T_SEL0 else 4
            b = int(vals[8][0])
            for j in range(4):
                x, y = vals[j][0], vals[4 + j][0]
                base[j0 + j] = (base[j0 + j] + (y if b else x)) % PU
                base[8 + j0 + j] = (base[8 + j0 + j] + (x if b else y)) % PU
            st = base
        elif t in (T_DIG, T_DIGHI):
            off = 0 if t == T_DIG else 8
            for s in range(8):
                vals[s] = np.array([st[off + s], 0, 0, 0], dtype=np.uint64)
                _write(wom, written, addr[s], vals[s])
        else:
            raise AssertionError(t)
        main[r, ML.VAL:ML.VAL + 4 * N_SLOTS] = vals.reshape(-1)
        if r + 1 < n:
            main[r + 1, ML.ST:ML.ST + CELLS] = st
    assert sp == pr.n_stream
    return main, wom


def _write(wom, written, a, v):
    a = int(a)
    assert not written[a], f"WOM cell {a} written twice"
    written[a] = True
    wom[a] = v


def _ext_layer_np(x: np.ndarray) -> np.ndarray:
    return P2._external_np(x.reshape(CELLS, 1))[:, 0]


# which slots each row type READS (for witgen)
_READ_SLOTS = {
    T_FMA: (0, 1, 2, 3, 4), T_IN: (), T_BIT: (), T_ASSERT: (0,),
    T_PUB: (0,), T_INIT: (), T_REXT: (), T_RINT: (),
    T_ABSLO: tuple(range(8)), T_ABSHI: tuple(range(8)),
    T_SEL0: tuple(range(9)), T_SEL4: tuple(range(9)),
    T_DIG: (), T_DIGHI: (),
}
