"""Frozen copy of ``zeth_tpu_torch/circuits/rv32im.py`` (the RV32IM AIR: its
layout, control trace, derived challenges and constraints, and the
publics helpers; no witness generation); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..hostmath import P
from ..zkp.air import Air


# instruction classes (selector layout); PAD = rows after halt
CLASSES = [
    ("LUI", 0x37), ("AUIPC", 0x17), ("JAL", 0x6F), ("JALR", 0x67),
    ("BRANCH", 0x63), ("LOAD", 0x03), ("STORE", 0x23), ("OPIMM", 0x13),
    ("OP", 0x33), ("SYSTEM", 0x73), ("FENCE", 0x0F), ("PAD", 0x00),
    ("INIT", 0x00),    # rows 0..31: register-file init writes (one per reg)
    ("SYSMEM", 0x00),  # syscall IO phantom rows (one word each)
    ("MEMINIT", 0x00), # RAM argument: segment-entry value of a touched word
    ("MEMFIN", 0x00),  # RAM argument: segment-exit read of a touched word
    ("REGFIN", 0x00),  # register argument: segment-exit read of one register
]
NCLASS = len(CLASSES)
CLASS_IDX = {name: i for i, (name, _) in enumerate(CLASSES)}

N_INIT_ROWS = 32     # one register-init write row per register
N_REG_UNITS = 4      # r1/a0, r2/a1, rd-write, a7 (ecall rows)
ORD_BITS = 24        # sorted-order diffs (reg arg: ts = 4*cycle+unit < 2^23)
N_MEM_UNITS = 2      # word read unit, word write unit
MS_ORD_BITS = 30     # mem arg: word-address diffs < 2^30
# classes whose result is written back to rd
WB_CLASSES = ("LUI", "AUIPC", "JAL", "JALR", "OPIMM", "OP", "LOAD")
# syscall numbers (one-hot "sk" selector order; zkVM ABI in executor)
SYSCALLS = ("HALT", "READ", "COMMIT", "LOG", "CYCLE", "KECCAK",
            "BIGINT", "SHA256")
# SYSMEM stream one-hot order: input write / journal read / keccak r/w /
# bigint r/w / sha-256 r/w (trace stream tags SM_* in the executor;
# bigint runs are 36 reads + 12 writes at the 384-bit width, sha runs
# 24 reads + 8 writes)
SM_STREAMS = ("in_w", "j_r", "k_r", "k_w", "b_r", "b_w", "s_r", "s_w")


class Layout:
    """Named main-column index ranges."""

    def __init__(self):
        self.n = 0
        self.slices: dict[str, slice] = {}
        for name, width in [
            ("pc", 32), ("insn", 32), ("rs1v", 32), ("rs2v", 32),
            ("res", 32), ("sel", NCLASS), ("f3_sel", 8),
            ("cmp_d", 32), ("cmp_c1", 1), ("cmp_lt", 1),
            ("eq_lo", 1), ("eq_hi", 1), ("eq_inv_lo", 1), ("eq_inv_hi", 1),
            ("sh_sel", 32),
            ("alu_c1", 1), ("alu_c2", 1),
            ("npc_c1", 1), ("npc_c2", 1),
            ("jalr_lsb", 1), ("taken", 1), ("sub", 1), ("op_alu", 1),
            ("rom_m", 1),
            # register-file memory argument: rd != 0 helper + the sorted
            # access trace (3 units per row, sorted by (reg, cycle, unit))
            ("rd_nz", 1), ("rd_inv", 1),
            ("m_reg", N_REG_UNITS), ("m_cyc", N_REG_UNITS),
            ("m_vlo", N_REG_UNITS), ("m_vhi", N_REG_UNITS),
            ("m_wr", N_REG_UNITS), ("m_act", N_REG_UNITS),
            ("m_same", N_REG_UNITS),
            ("ord_bits", N_REG_UNITS * ORD_BITS),
            # data-memory unit (RAM argument): byte address (adder output;
            # a7 value on SYSTEM rows), loaded/old word, written word,
            # byte-select one-hot, addr-adder carries
            ("maddr", 32), ("madd_c1", 1), ("madd_c2", 1),
            ("mword", 32), ("mwnew", 32), ("bsel", 4),
            # SYSMEM run structure: stream one-hot, base addr (a0 of the
            # initiating ecall), +4 chain carry, words-remaining counter,
            # rem==1/51/9/13 indicators (run-end / keccak / sha / bigint
            # read->write switch rows)
            ("sm_str", 8), ("sm_base_l", 1), ("sm_base_h", 1), ("sm_c", 1),
            ("sm_rem", 20), ("sm_eq1", 1), ("sm_eq1i", 1),
            ("sm_eq51", 1), ("sm_eq51i", 1),
            ("sm_eq9", 1), ("sm_eq9i", 1),
            ("sm_eq13", 1), ("sm_eq13i", 1),
            # syscall selector one-hot (SYSTEM rows; bound to a7)
            ("sk", len(SYSCALLS)),
            # sorted data-memory access trace: 2 units per row, sorted by
            # (word address, timestamp); kind: 0=normal 1=init 2=fin
            ("ms_wa", N_MEM_UNITS), ("ms_ts", N_MEM_UNITS),
            ("ms_vlo", N_MEM_UNITS), ("ms_vhi", N_MEM_UNITS),
            ("ms_wr", N_MEM_UNITS), ("ms_act", N_MEM_UNITS),
            ("ms_same", N_MEM_UNITS), ("ms_kind", N_MEM_UNITS),
            ("ms_ord", N_MEM_UNITS * MS_ORD_BITS),
            # M-extension multiply unit: committed operands/products,
            # 8-bit-limb carry chain (7 carries x 12 bits), signed-adjust
            # borrows; abs_a/abs_b + negation carries back the signed
            # DIV/REM path (divide unit runs on magnitudes)
            ("is_m", 1), ("mula", 32), ("mulb", 32),
            ("mullo", 32), ("mulhi", 32),
            ("mul_c", 7 * 12), ("madj_k", 4),
            ("abs_a", 32), ("abs_b", 32), ("abs_ca1", 1), ("abs_cb1", 1),
            ("sneg_c1", 1), ("sneg_c2", 1),
            # DIVU/REMU unit: q, r, the range witness t = b-r-1, carries,
            # b==0 detection, and committed gates
            ("mdiv_q", 32), ("mdiv_r", 32), ("mdiv_t", 32),
            ("mdiv_c1", 1), ("mdiv_e1", 1),
            ("bz_lo_eq", 1), ("bz_lo_inv", 1), ("bz_hi_eq", 1),
            ("bz_hi_inv", 1), ("div_en", 1), ("div0", 1),
            # REGFIN register index counter (exit-register read rows)
            ("rf_idx", 5),
        ]:
            self.slices[name] = slice(self.n, self.n + width)
            self.n += width

    def idx(self, name: str, k: int = 0) -> int:
        s = self.slices[name]
        assert s.start + k < s.stop
        return s.start + k


LAYOUT = Layout()

# control columns
C_IS_FIRST, C_IS_LAST = 0, 1
C_ROM_ALO, C_ROM_AHI, C_ROM_WLO, C_ROM_WHI = 2, 3, 4, 5
C_CYCLE, C_IS_INIT = 6, 7
N_CONTROL = 8

# aux columns (LogUp): t = fetch term, u = rom term, acc = running sum;
# register argument: 3 unsorted + 3 sorted access terms + running sum.
# Every aux value is a full Fp4 extension element stored as 4 base
# columns (slot k -> columns 4k..4k+3): LogUp denominators use full
# extension challenges (ADVICE.md r1 finding #1 — a single base-field
# challenge is grindable).
A_T, A_U, A_ACC = 0, 1, 2
A_RU = 3           # register unsorted access terms (4 units)
A_RS = 7           # register sorted access terms (4 units)
A_RACC = 11
A_MU = 12          # memory unsorted terms (R, W)
A_MS = 14          # memory sorted terms (2 units)
A_MACC = 16
A_LI, A_LF = 17, 18      # MEMINIT / MEMFIN list-binding terms
A_LIA, A_LFA = 19, 20    # their running sums (bound to derived scalars)
A_RJ, A_RK = 21, 22      # journal / keccak-IO RLC chains
A_RB = 23                # bigint-accelerator-IO RLC chain
A_RSH = 24               # sha-256-accelerator-IO RLC chain
A_RRE = 25               # entry-register RLC chain (INIT rows, bound to
                         # the public entry-register list)
A_RRX = 26               # exit-register RLC chain (REGFIN rows, bound to
                         # the public exit-register list)
# (SYS_READ input words are nondeterministic witness, as in the
# reference zkVM — they are NOT exposed or bound in publics)
N_AUX_SLOTS = 27
N_AUX = 4 * N_AUX_SLOTS

# bit lists for immediates: entry is ("b", insn_bit_index) or 0
def _imm_bits(kind: str):
    b = lambda i: ("b", i)
    if kind == "i":
        return [b(20 + j) for j in range(11)] + [b(31)] * 21
    if kind == "u":
        return [0] * 12 + [b(12 + j) for j in range(20)]
    if kind == "j":
        return ([0] + [b(21 + j) for j in range(10)] + [b(20)]
                + [b(12 + j) for j in range(8)] + [b(31)] * 12)
    if kind == "b":
        return ([0] + [b(8 + j) for j in range(4)]
                + [b(25 + j) for j in range(6)] + [b(7)] + [b(31)] * 20)
    if kind == "s":
        return ([b(7 + j) for j in range(5)]
                + [b(25 + j) for j in range(6)] + [b(31)] * 21)
    raise ValueError(kind)


def _imm_value(kind: str, insn: np.ndarray) -> np.ndarray:
    """Numpy value of the immediate (uint64, as u32)."""
    insn = insn.astype(np.uint64)
    out = np.zeros_like(insn)
    for j, e in enumerate(_imm_bits(kind)):
        if e != 0:
            out += ((insn >> np.uint64(e[1])) & np.uint64(1)) << np.uint64(j)
    return out & np.uint64(0xFFFFFFFF)


# main columns that carry field values rather than bits (everything else
# is bit-packed for the host->device witness upload)
_VALUE_COLS = ("eq_inv_lo", "eq_inv_hi", "rd_inv", "bz_lo_inv", "bz_hi_inv",
               "rom_m", "m_reg", "m_cyc", "m_vlo", "m_vhi",
               "ms_wa", "ms_ts", "ms_vlo", "ms_vhi", "ms_kind",
               "sm_base_l", "sm_base_h", "sm_eq1i", "sm_eq51i", "sm_eq9i",
               "sm_eq13i")


def _main_bit_mask() -> np.ndarray:
    mask = np.ones(LAYOUT.n, dtype=bool)
    for name in _VALUE_COLS:
        mask[LAYOUT.slices[name]] = False
    return mask


class Rv32imAir(Air):
    """AIR for one execution segment of a fixed public program image."""

    control_cols = N_CONTROL
    main_cols = LAYOUT.n
    aux_cols = N_AUX
    main_bit_mask = _main_bit_mask()
    # g0/g1: fetch LogUp; g2/g3: register argument; g4/g5: RAM argument;
    # g6: IO RLC chains
    n_challenges = 7
    # derived (not sampled) challenge-like scalars, computed by prover AND
    # verifier from the public lists + sampled challenges:
    # d0/d1 = MEMINIT/MEMFIN LogUp sums, d2..d5 = journal/keccak/bigint/
    # sha RLCs, d6/d7 = entry/exit register RLCs (cross-segment register
    # continuity — the reference chains the full machine state across
    # segments, crates/host/src/lib.rs segment claims)
    n_derived = 8
    # publics beyond index 6 are the variable-length lists; only the first
    # 7 scalars enter constraints directly
    n_public_scalars = 7
    # the transcript absorbs the companion paging proof's main root
    # before sampling challenges (prover.prove extra_mix)
    uses_extra_mix = True

    def __init__(self, image_addrs: np.ndarray, image_words: np.ndarray):
        """image_*: the initial memory image (sorted by address)."""
        self.image_addrs = np.asarray(image_addrs, dtype=np.uint64)
        self.image_words = np.asarray(image_words, dtype=np.uint64)
        import hashlib
        h = hashlib.sha256(
            self.image_addrs.tobytes() + self.image_words.tobytes()).hexdigest()[:16]
        self.name = f"rv32im:{h}"

    # -- control / ROM -----------------------------------------------------

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        assert len(self.image_addrs) <= n, "image larger than segment rows"
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        cols[0, C_IS_FIRST] = 1
        cols[-1, C_IS_LAST] = 1
        k = len(self.image_addrs)
        addrs = np.zeros(n, dtype=np.uint64)
        words = np.zeros(n, dtype=np.uint64)
        addrs[:k] = self.image_addrs
        words[:k] = self.image_words
        if k:
            # pad with fresh distinct addresses so ROM keys stay unique
            top = int(self.image_addrs[-1])
            addrs[k:] = (top + 4 * np.arange(1, n - k + 1)) & 0xFFFFFFFF
        else:
            addrs[:] = 4 * np.arange(n)
        cols[:, C_ROM_ALO] = addrs & 0xFFFF
        cols[:, C_ROM_AHI] = addrs >> np.uint64(16)
        cols[:, C_ROM_WLO] = words & 0xFFFF
        cols[:, C_ROM_WHI] = words >> np.uint64(16)
        cols[:, C_CYCLE] = np.arange(n)
        cols[:N_INIT_ROWS, C_IS_INIT] = 1
        return cols

    # -- witgen ------------------------------------------------------------

    # -- aux (LogUp) -------------------------------------------------------

    # -- derived challenge scalars ----------------------------------------

    def derived_challenges(self, publics, challenges, extra=None):
        """d0/d1: MEMINIT/MEMFIN boundary sums, bound by the companion
        paging proof (passed via ``extra`` — prover: computed from the
        segment's boundary lists; verifier: the paging proof's public
        d0/d1). d2..d7: journal/keccak/bigint/sha/entry-reg/exit-reg
        RLCs, computed identically by both sides from the public lists.
        They appear to the constraint system as extra challenge entries
        (indices 7..14).
        """
        if extra is None:
            raise ValueError(
                "rv32im derived challenges need the paging-bound d0/d1 "
                "(pass derived_extra={'d0':..., 'd1':...})")
        pp = parse_publics(publics)
        g6 = H.ext(np.asarray(challenges[6], np.uint64))
        return np.stack([
            np.asarray(extra["d0"], np.uint64).reshape(4),
            np.asarray(extra["d1"], np.uint64).reshape(4),
            _rlc(pp["journal_words"], g6),
            _rlc(pp["keccak_words"], g6),
            _rlc(pp["bigint_words"], g6),
            _rlc(pp["sha_words"], g6),
            _rlc(pp["entry_regs"], g6),
            _rlc(pp["exit_regs"], g6),
        ])

    # -- recursion-circuit hooks --------------------------------------------

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        from ..zkp.air import cadd, cext, cmul, cmul_base, csub
        L = LAYOUT
        one = ops.const(1)
        g0 = challenges[0]      # 4-tuples: full Fp4 challenges
        g1v = challenges[1]

        def aux(k, off=0):
            """Aux slot k as a circuit-ext 4-tuple."""
            return tuple(v("aux", 4 * k + c, off) for c in range(4))

        def m(name, k=0, off=0):
            return v("main", L.idx(name, k), off)

        def sel(name, off=0):
            return m("sel", CLASS_IDX[name], off)

        def ctl(k, off=0):
            return v("control", k, off)

        add, sub_, mul = ops.add, ops.sub, ops.mul

        def lin(pairs):
            """sum of coeff*expr (coeff python int)."""
            acc = None
            for coeff, e in pairs:
                term = e if coeff == 1 else mul(ops.const(coeff), e)
                acc = term if acc is None else add(acc, term)
            return acc if acc is not None else ops.const(0)

        _lump_cache = {}

        def lump(name, lo, off=0):
            key = (name, lo, off)
            if key not in _lump_cache:
                r = range(0, 16) if lo else range(16, 32)
                _lump_cache[key] = lin(
                    [(1 << (j % 16), m(name, j, off)) for j in r])
            return _lump_cache[key]

        def imm_lump(kind, lo):
            key = ("imm", kind, lo)
            if key not in _lump_cache:
                bits = _imm_bits(kind)
                r = range(0, 16) if lo else range(16, 32)
                pairs = []
                for j in r:
                    e = bits[j]
                    if e != 0:
                        pairs.append((1 << (j % 16), m("insn", e[1])))
                _lump_cache[key] = lin(pairs)
            return _lump_cache[key]

        cs = []

        # --- booleanity ---------------------------------------------------
        bool_cols = (["pc", "insn", "rs1v", "rs2v", "res", "cmp_d", "sh_sel",
                      "sel", "f3_sel"]
                     + ["cmp_c1", "cmp_lt", "eq_lo", "eq_hi", "alu_c1",
                        "alu_c2", "npc_c1", "npc_c2", "jalr_lsb", "taken",
                        "sub", "op_alu", "rd_nz", "m_wr", "m_act", "m_same"]
                     + ["ord_bits", "mula", "mulb", "mullo", "mulhi",
                        "mul_c", "madj_k", "is_m", "mdiv_q", "mdiv_r",
                        "mdiv_t", "mdiv_c1", "mdiv_e1", "bz_lo_eq",
                        "bz_hi_eq", "div_en", "div0", "abs_a", "abs_b",
                        "abs_ca1", "abs_cb1", "sneg_c1", "sneg_c2"]
                     + ["maddr", "madd_c1", "madd_c2", "mword", "mwnew",
                        "bsel", "sm_str", "sm_c", "sm_rem", "sm_eq1",
                        "sm_eq51", "sm_eq9", "sm_eq13", "sk", "ms_wr",
                        "ms_act",
                        "ms_same", "ms_ord", "rf_idx"])
        for name in bool_cols:
            s = L.slices[name]
            for k in range(s.stop - s.start):
                b = m(name, k)
                cs.append(mul(b, sub_(b, one)))

        # --- selectors ----------------------------------------------------
        opc_val = lin([(1 << i, m("insn", i)) for i in range(7)])
        sel_sum = lin([(1, sel(nm)) for nm, _ in CLASSES])
        cs.append(sub_(sel_sum, one))
        for nm, opc in CLASSES:
            if nm == "PAD":
                continue
            cs.append(mul(sel(nm), sub_(opc_val, ops.const(opc))))
        for nm in ("PAD", "INIT", "SYSMEM", "MEMINIT", "MEMFIN", "REGFIN"):
            cs.append(mul(sel(nm), lump("insn", True)))
            cs.append(mul(sel(nm), lump("insn", False)))
        # SYSTEM rows carry exactly the ecall encoding 0x00000073 (the
        # circuit reads a0/a1/a7, so rs1/rs2/rd fields must be zero)
        cs.append(mul(sel("SYSTEM"), sub_(lump("insn", True),
                                          ops.const(0x73))))
        cs.append(mul(sel("SYSTEM"), lump("insn", False)))
        # init rows are exactly the control-designated leading rows
        cs.append(sub_(sel("INIT"), ctl(C_IS_INIT)))
        # padding is terminal (until last row)
        not_last = sub_(one, ctl(C_IS_LAST))
        cs.append(mul(mul(sel("PAD"), sub_(one, sel("PAD", 1))), not_last))

        # f3 one-hot binding
        f3_sum = lin([(1, m("f3_sel", k)) for k in range(8)])
        cs.append(sub_(f3_sum, one))
        f3_idx = lin([(k, m("f3_sel", k)) for k in range(1, 8)])
        f3_val = lin([(1 << (i - 12), m("insn", i)) for i in range(12, 15)])
        cs.append(sub_(f3_idx, f3_val))

        def f3(k, off=0):
            return m("f3_sel", k, off)

        # --- equality unit (rs1 vs rs2 limbs) -----------------------------
        for lo, eqn, invn in ((True, "eq_lo", "eq_inv_lo"),
                              (False, "eq_hi", "eq_inv_hi")):
            diff = sub_(lump("rs1v", lo), lump("rs2v", lo))
            cs.append(mul(m(eqn), diff))
            cs.append(sub_(sub_(one, m(eqn)), mul(diff, m(invn))))
        eq = mul(m("eq_lo"), m("eq_hi"))

        # --- compare unit -------------------------------------------------
        # operands: a = rs1 (hi bit flipped when signed), b = imm (OPIMM) or
        # rs2 (flipped when signed); signed = BRANCH&f3 in {4,5} | (OP|OPIMM)&f3=2
        signed = add(mul(sel("BRANCH"), add(f3(4), f3(5))),
                     mul(add(sel("OP"), sel("OPIMM")), f3(2)))
        use_imm = sel("OPIMM")
        b_lo = add(mul(use_imm, imm_lump("i", True)),
                   mul(sub_(one, use_imm), lump("rs2v", True)))
        b_hi_raw = add(mul(use_imm, imm_lump("i", False)),
                       mul(sub_(one, use_imm), lump("rs2v", False)))
        # flipping bit31 adds (1 - 2*b31)*2^15; bit31 of b depends on operand
        b_b31 = add(mul(use_imm, m("insn", 31)),
                    mul(sub_(one, use_imm), m("rs2v", 31)))
        two15 = ops.const(1 << 15)
        b_hi = add(b_hi_raw, mul(signed,
                   sub_(two15, mul(ops.const(1 << 16), b_b31))))
        a_hi = add(lump("rs1v", False), mul(signed,
                   sub_(two15, mul(ops.const(1 << 16), m("rs1v", 31)))))
        a_lo = lump("rs1v", True)
        two16 = ops.const(1 << 16)
        cs.append(sub_(add(b_lo, lump("cmp_d", True)),
                       add(a_lo, mul(two16, m("cmp_c1")))))
        cs.append(sub_(add(add(b_hi, lump("cmp_d", False)), m("cmp_c1")),
                       add(a_hi, mul(two16, m("cmp_lt")))))
        lt = m("cmp_lt")

        # --- ALU adder (shared carries) -----------------------------------
        def adder(gate, a_lo_e, a_hi_e, b_lo_e, b_hi_e, cin, out="res"):
            cs.append(mul(gate, sub_(add(add(a_lo_e, b_lo_e), cin),
                                     add(lump(out, True),
                                         mul(two16, m("alu_c1"))))))
            cs.append(mul(gate, sub_(add(add(a_hi_e, b_hi_e), m("alu_c1")),
                                     add(lump(out, False),
                                         mul(two16, m("alu_c2"))))))

        # ADDI
        adder(mul(sel("OPIMM"), f3(0)),
              lump("rs1v", True), lump("rs1v", False),
              imm_lump("i", True), imm_lump("i", False), ops.const(0))
        # ADD/SUB: b' = rs2 xor sub (bitwise), cin = sub
        op_alu = m("op_alu")
        cs.append(sub_(op_alu, mul(sel("OP"), sub_(one, m("insn", 25)))))
        is_m = m("is_m")
        cs.append(sub_(is_m, mul(sel("OP"), m("insn", 25))))

        # --- M-extension multiply unit (MUL/MULH/MULHSU/MULHU) ------------
        def limb8(name, k, off_name=None):
            src_name = name
            return lin([(1 << j, m(src_name, 8 * k + j)) for j in range(8)])

        def prod_limbs(k):
            """sum of A_i*B_j with i+j=k (8-bit limbs of mula, mulb)."""
            acc = None
            for i in range(max(0, k - 3), min(3, k) + 1):
                t2 = mul(limb8("mula", i), limb8("mulb", k - i))
                acc = t2 if acc is None else add(acc, t2)
            return acc

        def carry_lump(k):
            return lin([(1 << j, m("mul_c", 12 * k + j)) for j in range(12)])

        def lump_of2(name, lo):
            r = range(0, 16) if lo else range(16, 32)
            return lin([(1 << (j % 16), m(name, j)) for j in r])

        def out_limb(k):
            if k < 4:
                return limb8("mullo", k)
            return limb8("mulhi", k - 4)

        gate_mul4 = mul(is_m, add(add(f3(0), f3(1)), add(f3(2), f3(3))))
        gate_divu = mul(is_m, add(f3(5), f3(7)))
        gate_sdiv = mul(is_m, add(f3(4), f3(6)))
        gate_div = add(gate_divu, gate_sdiv)
        gate_chain = add(gate_mul4, gate_div)
        # operand binding: A = rs1 for multiplies / the quotient for
        # divides; B = rs2 except signed divides use |rs2|
        for lo_flag in (True, False):
            cs.append(mul(gate_mul4, sub_(lump_of2("mula", lo_flag),
                                          lump("rs1v", lo_flag))))
            cs.append(mul(gate_div, sub_(lump_of2("mula", lo_flag),
                                         lump_of2("mdiv_q", lo_flag))))
            cs.append(mul(add(gate_mul4, gate_divu),
                          sub_(lump_of2("mulb", lo_flag),
                               lump("rs2v", lo_flag))))
            cs.append(mul(gate_sdiv, sub_(lump_of2("mulb", lo_flag),
                                          lump_of2("abs_b", lo_flag))))
        # |x| relations: sign=0 -> abs = x; sign=1 -> x + abs = 2^32
        two16m2 = ops.const(1 << 16)
        for src, absn, sbit, cn in (("rs1v", "abs_a", m("rs1v", 31), "abs_ca1"),
                                    ("rs2v", "abs_b", m("rs2v", 31), "abs_cb1")):
            for lo_flag in (True, False):
                cs.append(mul(mul(gate_sdiv, sub_(one, sbit)),
                              sub_(lump_of2(absn, lo_flag),
                                   lump(src, lo_flag))))
            cs.append(mul(mul(gate_sdiv, sbit),
                          sub_(add(lump(src, True), lump_of2(absn, True)),
                               mul(two16m2, m(cn)))))
            cs.append(mul(mul(gate_sdiv, sbit),
                          sub_(add(add(lump(src, False),
                                       lump_of2(absn, False)), m(cn)),
                               two16m2)))
        for k in range(7):
            expr = prod_limbs(k)
            if k > 0:
                expr = add(expr, carry_lump(k - 1))
            expr = sub_(expr, add(out_limb(k),
                                  mul(ops.const(256), carry_lump(k))))
            cs.append(mul(gate_chain, expr))
        cs.append(mul(gate_chain, sub_(carry_lump(6), out_limb(7))))

        def lump_of(name, lo):
            r = range(0, 16) if lo else range(16, 32)
            return lin([(1 << (j % 16), m(name, j)) for j in r])

        # result binding per variant
        g = mul(is_m, f3(0))       # MUL: rd = lo
        cs.append(mul(g, sub_(lump("res", True), lump_of("mullo", True))))
        cs.append(mul(g, sub_(lump("res", False), lump_of("mullo", False))))
        g = mul(is_m, f3(3))       # MULHU: rd = hi (unsigned)
        cs.append(mul(g, sub_(lump("res", True), lump_of("mulhi", True))))
        cs.append(mul(g, sub_(lump("res", False), lump_of("mulhi", False))))
        # MULH / MULHSU: rd + adj = hi_u (mod 2^32), adj = a31*b [+ b31*a]
        a31 = m("rs1v", 31)
        b31 = m("rs2v", 31)
        k1 = lin([(1, m("madj_k", 0)), (2, m("madj_k", 1))])
        k2 = lin([(1, m("madj_k", 2)), (2, m("madj_k", 3))])
        two16c = ops.const(1 << 16)
        for f3k, use_b31 in ((1, True), (2, False)):
            gk = mul(is_m, f3(f3k))
            adj_lo = mul(a31, lump("rs2v", True))
            adj_hi = mul(a31, lump("rs2v", False))
            if use_b31:
                adj_lo = add(adj_lo, mul(b31, lump("rs1v", True)))
                adj_hi = add(adj_hi, mul(b31, lump("rs1v", False)))
            cs.append(mul(gk, sub_(add(lump("res", True), adj_lo),
                                   add(lump_of("mulhi", True),
                                       mul(two16c, k1)))))
            cs.append(mul(gk, sub_(add(add(lump("res", False), adj_hi), k1),
                                   add(lump_of("mulhi", False),
                                       mul(two16c, k2)))))

        # --- DIVU / REMU ---------------------------------------------------
        # b == 0 detection per limb (eq + inverse trick, gated by the unit)
        blo = lump("rs2v", True)
        bhi = lump("rs2v", False)
        cs.append(mul(gate_div, mul(m("bz_lo_eq"), blo)))
        cs.append(mul(gate_div, sub_(sub_(one, m("bz_lo_eq")),
                                     mul(blo, m("bz_lo_inv")))))
        cs.append(mul(gate_div, mul(m("bz_hi_eq"), bhi)))
        cs.append(mul(gate_div, sub_(sub_(one, m("bz_hi_eq")),
                                     mul(bhi, m("bz_hi_inv")))))
        b_zero = mul(m("bz_lo_eq"), m("bz_hi_eq"))
        # committed gates: div_en = div & b!=0, div0 = div & b==0
        cs.append(sub_(m("div_en"), mul(gate_div, sub_(one, b_zero))))
        cs.append(sub_(m("div0"), mul(gate_div, b_zero)))
        den = m("div_en")
        # q*b must not overflow 32 bits
        cs.append(mul(den, lump_of("mulhi", True)))
        cs.append(mul(den, lump_of("mulhi", False)))
        # q*b + r = dividend (exactly; the top carry must be zero).
        # unsigned divides run on rs1/rs2; signed on |rs1|/|rs2|.
        f3u = add(f3(5), f3(7))
        f3s = add(f3(4), f3(6))

        def dvd(lo_flag):
            return add(mul(f3u, lump("rs1v", lo_flag)),
                       mul(f3s, lump_of2("abs_a", lo_flag)))

        cs.append(mul(den, sub_(add(lump_of("mullo", True),
                                    lump_of2("mdiv_r", True)),
                                add(dvd(True),
                                    mul(two16c, m("mdiv_c1"))))))
        cs.append(mul(den, sub_(add(add(lump_of("mullo", False),
                                        lump_of2("mdiv_r", False)),
                                    m("mdiv_c1")),
                                dvd(False))))
        # r < b  via  r + 1 + t = b (t >= 0 committed in bits, no
        # overflow); b is the divide unit's B operand (mulb = |rs2| for
        # signed rows)
        cs.append(mul(den, sub_(add(add(lump_of2("mdiv_r", True), one),
                                    lump_of2("mdiv_t", True)),
                                add(lump_of2("mulb", True),
                                    mul(two16c, m("mdiv_e1"))))))
        cs.append(mul(den, sub_(add(add(lump_of2("mdiv_r", False),
                                        lump_of2("mdiv_t", False)),
                                    m("mdiv_e1")),
                                lump_of2("mulb", False))))
        # result binding: DIVU -> q, REMU -> r; b==0: q=0xFFFFFFFF, r=a
        cs.append(mul(mul(den, f3(5)), sub_(lump("res", True),
                                            lump_of2("mdiv_q", True))))
        cs.append(mul(mul(den, f3(5)), sub_(lump("res", False),
                                            lump_of2("mdiv_q", False))))
        cs.append(mul(mul(den, f3(7)), sub_(lump("res", True),
                                            lump_of2("mdiv_r", True))))
        cs.append(mul(mul(den, f3(7)), sub_(lump("res", False),
                                            lump_of2("mdiv_r", False))))
        # signed result binding: res = sign ? -abs_res : abs_res where
        # abs_res is the unit's q (DIV) or r (REM); negation mod 2^32 via
        # committed carries (res + abs_res in {0, 2^32})
        a31d = m("rs1v", 31)
        b31d = m("rs2v", 31)
        sign_q = sub_(add(a31d, b31d), mul(ops.const(2), mul(a31d, b31d)))
        for f3k, absn, sgn in ((4, "mdiv_q", sign_q), (6, "mdiv_r", a31d)):
            gk = mul(den, f3(f3k))
            pos = sub_(one, sgn)
            cs.append(mul(mul(gk, pos), sub_(lump("res", True),
                                             lump_of2(absn, True))))
            cs.append(mul(mul(gk, pos), sub_(lump("res", False),
                                             lump_of2(absn, False))))
            cs.append(mul(mul(gk, sgn),
                          sub_(add(lump("res", True), lump_of2(absn, True)),
                               mul(two16c, m("sneg_c1")))))
            cs.append(mul(mul(gk, sgn),
                          sub_(add(add(lump("res", False),
                                       lump_of2(absn, False)),
                                   m("sneg_c1")),
                               mul(two16c, m("sneg_c2")))))
        dz = m("div0")
        # division by zero: DIV/DIVU -> all-ones, REM/REMU -> rs1
        for f3k in (4, 5):
            cs.append(mul(mul(dz, f3(f3k)), sub_(lump("res", True),
                                                 ops.const(0xFFFF))))
            cs.append(mul(mul(dz, f3(f3k)), sub_(lump("res", False),
                                                 ops.const(0xFFFF))))
        for f3k in (6, 7):
            cs.append(mul(mul(dz, f3(f3k)), sub_(lump("res", True),
                                                 lump("rs1v", True))))
            cs.append(mul(mul(dz, f3(f3k)), sub_(lump("res", False),
                                                 lump("rs1v", False))))
        subf = m("sub")
        cs.append(sub_(subf, mul(mul(op_alu, f3(0)), m("insn", 30))))

        def xor_lump(name, flag, lo):
            r = range(0, 16) if lo else range(16, 32)
            return lin([(1 << (j % 16),
                         add(m(name, j), mul(flag, sub_(one, mul(ops.const(2), m(name, j))))))
                        for j in r])
        adder(mul(op_alu, f3(0)),
              lump("rs1v", True), lump("rs1v", False),
              xor_lump("rs2v", subf, True), xor_lump("rs2v", subf, False),
              subf)
        # AUIPC: res = pc + imm_u
        adder(sel("AUIPC"), lump("pc", True), lump("pc", False),
              imm_lump("u", True), imm_lump("u", False), ops.const(0))
        # JAL/JALR: res = pc + 4
        adder(add(sel("JAL"), sel("JALR")), lump("pc", True), lump("pc", False),
              ops.const(4), ops.const(0), ops.const(0))
        # LUI: res = imm_u
        cs.append(mul(sel("LUI"), sub_(lump("res", True), imm_lump("u", True))))
        cs.append(mul(sel("LUI"), sub_(lump("res", False), imm_lump("u", False))))

        # logic ops (bitwise): AND f3=7, OR f3=6, XOR f3=4
        for f3k, opname in ((7, "and"), (6, "or"), (4, "xor")):
            for cls, b_of in (("OPIMM", lambda j: _imm_bit_expr(m, j)),
                              ("OP", lambda j: m("rs2v", j))):
                gate = mul(op_alu if cls == "OP" else sel(cls), f3(f3k))
                for j in range(32):
                    a = m("rs1v", j)
                    b = b_of(j)
                    ab = mul(a, b)
                    if opname == "and":
                        val = ab
                    elif opname == "or":
                        val = sub_(add(a, b), ab)
                    else:
                        val = sub_(add(a, b), mul(ops.const(2), ab))
                    cs.append(mul(gate, sub_(m("res", j), val)))

        # shifts: one-hot shamt unit
        sh_sum = lin([(1, m("sh_sel", k)) for k in range(32)])
        cs.append(sub_(sh_sum, one))
        sh_idx = lin([(k, m("sh_sel", k)) for k in range(1, 32)])
        shamt_imm = lin([(1 << (i - 20), m("insn", i)) for i in range(20, 25)])
        shamt_reg = lin([(1 << j, m("rs2v", j)) for j in range(5)])
        shamt_v = add(mul(mul(sel("OPIMM"), add(f3(1), f3(5))), shamt_imm),
                      mul(mul(op_alu, add(f3(1), f3(5))), shamt_reg))
        cs.append(sub_(sh_idx, shamt_v))
        sra = m("insn", 30)
        for cls in ("OPIMM", "OP"):
            cls_sel = op_alu if cls == "OP" else sel(cls)
            gate_l = mul(cls_sel, f3(1))
            gate_r = mul(cls_sel, f3(5))
            for j in range(32):
                left = lin([(1, mul(m("sh_sel", k), m("rs1v", j - k)))
                            for k in range(0, j + 1)])
                cs.append(mul(gate_l, sub_(m("res", j), left)))
                rterms = [(1, mul(m("sh_sel", k), m("rs1v", j + k)))
                          for k in range(0, 32 - j)]
                rfill = [(1, mul(m("sh_sel", k), mul(sra, m("rs1v", 31))))
                         for k in range(32 - j, 32)]
                cs.append(mul(gate_r, sub_(m("res", j), lin(rterms + rfill))))

        # SLT/SLTU: res = lt (bit 0), rest zero
        for cls in ("OPIMM", "OP"):
            gate = mul(op_alu if cls == "OP" else sel(cls), add(f3(2), f3(3)))
            cs.append(mul(gate, sub_(m("res", 0), lt)))
            cs.append(mul(gate, lin([(1 << (j % 16), m("res", j))
                                     for j in range(1, 16)])))
            cs.append(mul(gate, lump("res", False)))

        # --- branch taken -------------------------------------------------
        cond = add(add(mul(f3(0), eq), mul(f3(1), sub_(one, eq))),
                   add(add(mul(f3(4), lt), mul(f3(5), sub_(one, lt))),
                       add(mul(f3(6), lt), mul(f3(7), sub_(one, lt)))))
        cs.append(mul(sel("BRANCH"), sub_(m("taken"), cond)))
        cs.append(mul(sub_(one, sel("BRANCH")), m("taken")))

        # --- next-pc adder ------------------------------------------------
        # A = pc (or rs1 for JALR); B per class; holds on every row but last
        jalr = sel("JALR")
        a_npc_lo = add(mul(jalr, lump("rs1v", True)),
                       mul(sub_(one, jalr), lump("pc", True)))
        a_npc_hi = add(mul(jalr, lump("rs1v", False)),
                       mul(sub_(one, jalr), lump("pc", False)))
        seq = lin([(1, sel(nm)) for nm in
                   ("LUI", "AUIPC", "LOAD", "STORE", "OPIMM", "OP",
                    "SYSTEM", "FENCE")])
        tk = m("taken")
        b_npc_lo = add(add(mul(seq, ops.const(4)),
                           mul(sel("JAL"), imm_lump("j", True))),
                       add(mul(jalr, sub_(imm_lump("i", True), m("jalr_lsb"))),
                           mul(sel("BRANCH"),
                               add(mul(tk, sub_(imm_lump("b", True),
                                                ops.const(4))),
                                   ops.const(4)))))
        b_npc_hi = add(add(mul(sel("JAL"), imm_lump("j", False)),
                           mul(jalr, imm_lump("i", False))),
                       mul(sel("BRANCH"), mul(tk, imm_lump("b", False))))
        cs.append(mul(not_last,
                      sub_(add(a_npc_lo, b_npc_lo),
                           add(lump("pc", True, 1), mul(two16, m("npc_c1"))))))
        cs.append(mul(not_last,
                      sub_(add(add(a_npc_hi, b_npc_hi), m("npc_c1")),
                           add(lump("pc", False, 1),
                               mul(two16, m("npc_c2"))))))

        # --- publics: entry / exit pc -------------------------------------
        isf, isl = ctl(C_IS_FIRST), ctl(C_IS_LAST)
        cs.append(mul(isf, sub_(lump("pc", True), publics[0])))
        cs.append(mul(isf, sub_(lump("pc", False), publics[1])))
        cs.append(mul(isl, sub_(lump("pc", True), publics[2])))
        cs.append(mul(isl, sub_(lump("pc", False), publics[3])))

        # --- LogUp program binding (full Fp4 challenges) -------------------
        g1_2 = cmul(ops, g1v, g1v)
        g1_3 = cmul(ops, g1_2, g1v)

        def fetch_key(vlo, vhi, wlo, whi):
            out = cext(ops, vlo)
            out = cadd(ops, out, cmul_base(ops, g1v, vhi))
            out = cadd(ops, out, cmul_base(ops, g1_2, wlo))
            return cadd(ops, out, cmul_base(ops, g1_3, whi))

        key_f = fetch_key(lump("pc", True), lump("pc", False),
                          lump("insn", True), lump("insn", False))
        key_r = fetch_key(ctl(C_ROM_ALO), ctl(C_ROM_AHI),
                          ctl(C_ROM_WLO), ctl(C_ROM_WHI))
        t = aux(A_T)
        u = aux(A_U)
        acc = aux(A_ACC)
        active = sub_(sub_(sub_(sub_(sub_(sub_(one, sel("PAD")),
                           sel("INIT")), sel("SYSMEM")), sel("MEMINIT")),
                           sel("MEMFIN")), sel("REGFIN"))
        cs.extend(csub(ops, cmul(ops, csub(ops, g0, key_f), t),
                       cext(ops, active)))
        cs.extend(csub(ops, cmul(ops, csub(ops, g0, key_r), u),
                       cext(ops, m("rom_m"))))
        cs.extend(cmul_base(ops, csub(ops, acc, csub(ops, t, u)), isf))
        cs.extend(cmul_base(
            ops,
            csub(ops, aux(A_ACC, 1),
                 cadd(ops, acc, csub(ops, aux(A_T, 1), aux(A_U, 1)))),
            not_last))
        cs.extend(cmul_base(ops, acc, isl))

        # --- register-file memory argument (challenges g2, g3) ------------
        g2 = challenges[2]
        g3 = challenges[3]
        g3_2 = cmul(ops, g3, g3)
        g3_3 = cmul(ops, g3_2, g3)
        g3_4 = cmul(ops, g3_3, g3)
        cyc = ctl(C_CYCLE)
        four_cyc = mul(ops.const(N_REG_UNITS), cyc)

        def fp(reg, ts, vlo, vhi, wr):
            out = cext(ops, reg)
            out = cadd(ops, out, cmul_base(ops, g3, ts))
            out = cadd(ops, out, cmul_base(ops, g3_2, vlo))
            out = cadd(ops, out, cmul_base(ops, g3_3, vhi))
            return cadd(ops, out, cmul_base(ops, g3_4, wr))

        rs1_f = lin([(1 << (i - 15), m("insn", i)) for i in range(15, 20)])
        rs2_f = lin([(1 << (i - 20), m("insn", i)) for i in range(20, 25)])
        rd_f = lin([(1 << (i - 7), m("insn", i)) for i in range(7, 12)])
        # rd_nz = (rd_f != 0) via the inverse trick
        rd_nz = m("rd_nz")
        cs.append(sub_(rd_nz, mul(rd_f, m("rd_inv"))))
        cs.append(mul(sub_(one, rd_nz), rd_f))

        sys = sel("SYSTEM")
        wb = lin([(1, sel(nm)) for nm in WB_CLASSES])
        w_act = add(mul(wb, rd_nz), sys)
        w_reg = add(add(mul(mul(wb, rd_nz), rd_f),
                        mul(sys, ops.const(10))),
                    mul(sel("INIT"), cyc))
        w_act_all = add(w_act, sel("INIT"))
        # ecall rows read a0/a1/a7 (rs1/rs2 fields are forced zero there);
        # REGFIN rows read register rf_idx through unit 0
        is_rf = sel("REGFIN")
        rf_idx = lin([(1 << j, m("rf_idx", j)) for j in range(5)])
        r1_reg = add(add(rs1_f, mul(sys, ops.const(10))),
                     mul(is_rf, rf_idx))
        r2_reg = add(rs2_f, mul(sys, ops.const(11)))

        fp_r1 = fp(r1_reg, four_cyc, lump("rs1v", True), lump("rs1v", False),
                   ops.const(0))
        fp_r2 = fp(r2_reg, add(four_cyc, one), lump("rs2v", True),
                   lump("rs2v", False), ops.const(0))
        fp_w = fp(w_reg, add(four_cyc, ops.const(2)), lump("res", True),
                  lump("res", False), one)
        fp_a7 = fp(mul(sys, ops.const(17)), add(four_cyc, ops.const(3)),
                   lump("maddr", True), lump("maddr", False), ops.const(0))
        t_r1, t_r2, t_w = aux(A_RU), aux(A_RU + 1), aux(A_RU + 2)
        t_a7 = aux(A_RU + 3)
        cs.extend(csub(ops, cmul(ops, csub(ops, g2, fp_r1), t_r1),
                       cext(ops, add(active, is_rf))))
        cs.extend(csub(ops, cmul(ops, csub(ops, g2, fp_r2), t_r2),
                       cext(ops, active)))
        cs.extend(csub(ops, cmul(ops, csub(ops, g2, fp_w), t_w),
                       cext(ops, w_act_all)))
        cs.extend(csub(ops, cmul(ops, csub(ops, g2, fp_a7), t_a7),
                       cext(ops, sys)))
        for u in range(N_REG_UNITS):
            fp_s = fp(m("m_reg", u), m("m_cyc", u), m("m_vlo", u),
                      m("m_vhi", u), m("m_wr", u))
            cs.extend(csub(ops, cmul(ops, csub(ops, g2, fp_s), aux(A_RS + u)),
                           cext(ops, m("m_act", u))))
        # running sum over (unsorted - sorted)
        def rdelta(off=0):
            d = aux(A_RU, off)
            for u in range(1, N_REG_UNITS):
                d = cadd(ops, d, aux(A_RU + u, off))
            for u in range(N_REG_UNITS):
                d = csub(ops, d, aux(A_RS + u, off))
            return d
        racc = aux(A_RACC)
        cs.extend(cmul_base(ops, csub(ops, racc, rdelta()), isf))
        cs.extend(cmul_base(
            ops, csub(ops, aux(A_RACC, 1), cadd(ops, racc, rdelta(1))),
            not_last))
        cs.extend(cmul_base(ops, racc, isl))

        # sorted-trace consistency: N_REG_UNITS boundaries per row
        def ord_lump(u, off=0):
            return lin([(1 << j, m("ord_bits", u * ORD_BITS + j, off))
                        for j in range(ORD_BITS)])

        def boundary(prev, nxt, gate_extra=None):
            """prev/nxt: dicts of field accessors."""
            actN = nxt["act"]
            if gate_extra is not None:
                actN = mul(gate_extra, actN)
            sameN = nxt["same"]
            cs.append(mul(actN, sub_(one, prev["act"])))        # prefix
            cs.append(mul(sameN, sub_(nxt["reg"], prev["reg"])))
            d = add(mul(sameN, sub_(sub_(nxt["ts"], prev["ts"]), one)),
                    mul(sub_(one, sameN),
                        sub_(sub_(nxt["reg"], prev["reg"]), one)))
            cs.append(mul(actN, sub_(d, nxt["ord"])))
            rd_gate = mul(actN, mul(sub_(one, nxt["wr"]), sameN))
            cs.append(mul(rd_gate, sub_(nxt["vlo"], prev["vlo"])))
            cs.append(mul(rd_gate, sub_(nxt["vhi"], prev["vhi"])))
            new_gate = mul(actN, mul(sub_(one, nxt["wr"]), sub_(one, sameN)))
            cs.append(mul(new_gate, nxt["vlo"]))
            cs.append(mul(new_gate, nxt["vhi"]))

        def unit(u, off=0):
            return {"reg": m("m_reg", u, off), "ts": m("m_cyc", u, off),
                    "vlo": m("m_vlo", u, off), "vhi": m("m_vhi", u, off),
                    "wr": m("m_wr", u, off), "act": m("m_act", u, off),
                    "same": m("m_same", u, off),
                    "ord": ord_lump(u, off)}

        for u in range(N_REG_UNITS - 1):
            boundary(unit(u), unit(u + 1))
        # cross-row: (row r, last unit) -> (row r+1, u0), gated not_last
        boundary(unit(N_REG_UNITS - 1), unit(0, 1), gate_extra=not_last)
        # the very first sorted entry has no predecessor
        cs.append(mul(isf, m("m_same", 0)))

        # ==================================================================
        # Data-memory (RAM) argument
        # ==================================================================
        g4 = challenges[4]
        g5 = challenges[5]
        g5_2 = cmul(ops, g5, g5)
        g5_3 = cmul(ops, g5_2, g5)
        g5_4 = cmul(ops, g5_3, g5)
        g5_5 = cmul(ops, g5_4, g5)
        is_load = sel("LOAD")
        is_store = sel("STORE")
        is_meminit = sel("MEMINIT")
        is_memfin = sel("MEMFIN")
        is_sm = sel("SYSMEM")
        in_w, j_r, k_r, k_w, b_r, b_w, s_r, s_w = (
            m("sm_str", k) for k in range(8))
        # stream one-hot sums to the SYSMEM selector
        cs.append(sub_(add(add(add(in_w, j_r), add(k_r, k_w)),
                           add(add(b_r, b_w), add(s_r, s_w))), is_sm))

        # --- load/store address adder + alignment + byte select -----------
        two16m = ops.const(1 << 16)
        mem_gate = add(is_load, is_store)
        b_mem_lo = add(mul(is_load, imm_lump("i", True)),
                       mul(is_store, imm_lump("s", True)))
        b_mem_hi = add(mul(is_load, imm_lump("i", False)),
                       mul(is_store, imm_lump("s", False)))
        cs.append(mul(mem_gate,
                      sub_(add(lump("rs1v", True), b_mem_lo),
                           add(lump("maddr", True),
                               mul(two16m, m("madd_c1"))))))
        cs.append(mul(mem_gate,
                      sub_(add(add(lump("rs1v", False), b_mem_hi),
                               m("madd_c1")),
                           add(lump("maddr", False),
                               mul(two16m, m("madd_c2"))))))
        # byte-select one-hot bound to the low address bits
        bsel_sum = lin([(1, m("bsel", k)) for k in range(4)])
        cs.append(sub_(bsel_sum, mem_gate))
        cs.append(sub_(add(m("bsel", 1), m("bsel", 3)),
                       mul(mem_gate, m("maddr", 0))))
        cs.append(sub_(add(m("bsel", 2), m("bsel", 3)),
                       mul(mem_gate, m("maddr", 1))))
        # alignment: words need addr%4==0, halfwords addr%2==0
        word_gate = add(mul(is_load, f3(2)), mul(is_store, f3(2)))
        cs.append(mul(word_gate, m("maddr", 0)))
        cs.append(mul(word_gate, m("maddr", 1)))
        half_gate = add(mul(is_load, add(f3(1), f3(5))),
                        mul(is_store, f3(1)))
        cs.append(mul(half_gate, m("maddr", 0)))
        # SYSMEM addresses are word-aligned
        cs.append(mul(is_sm, m("maddr", 0)))
        cs.append(mul(is_sm, m("maddr", 1)))

        # --- load extraction ----------------------------------------------
        def wbyte(k):
            return lin([(1 << j, m("mword", 8 * k + j)) for j in range(8)])

        byteval = lin([(1, mul(m("bsel", k), wbyte(k))) for k in range(4)])
        bsign = lin([(1, mul(m("bsel", k), m("mword", 8 * k + 7)))
                     for k in range(4)])
        a1b = m("maddr", 1)
        halfval = add(mul(sub_(one, a1b), lump("mword", True)),
                      mul(a1b, lump("mword", False)))
        hsign = add(mul(sub_(one, a1b), m("mword", 15)),
                    mul(a1b, m("mword", 31)))
        # LB (f3=0): res = sign-extended byte
        g = mul(is_load, f3(0))
        cs.append(mul(g, sub_(lump("res", True),
                              add(byteval, mul(bsign, ops.const(0xFF00))))))
        cs.append(mul(g, sub_(lump("res", False),
                              mul(bsign, ops.const(0xFFFF)))))
        # LBU (f3=4)
        g = mul(is_load, f3(4))
        cs.append(mul(g, sub_(lump("res", True), byteval)))
        cs.append(mul(g, lump("res", False)))
        # LH (f3=1)
        g = mul(is_load, f3(1))
        cs.append(mul(g, sub_(lump("res", True), halfval)))
        cs.append(mul(g, sub_(lump("res", False),
                              mul(hsign, ops.const(0xFFFF)))))
        # LHU (f3=5)
        g = mul(is_load, f3(5))
        cs.append(mul(g, sub_(lump("res", True), halfval)))
        cs.append(mul(g, lump("res", False)))
        # LW (f3=2)
        g = mul(is_load, f3(2))
        cs.append(mul(g, sub_(lump("res", True), lump("mword", True))))
        cs.append(mul(g, sub_(lump("res", False), lump("mword", False))))

        # --- store merge ---------------------------------------------------
        def nbyte(k):
            return lin([(1 << j, m("mwnew", 8 * k + j)) for j in range(8)])

        def r2byte0():
            return lin([(1 << j, m("rs2v", j)) for j in range(8)])

        g = mul(is_store, f3(0))      # SB
        for k in range(4):
            cs.append(mul(g, sub_(nbyte(k),
                                  add(mul(m("bsel", k), r2byte0()),
                                      mul(sub_(one, m("bsel", k)),
                                          wbyte(k))))))
        g = mul(is_store, f3(1))      # SH
        cs.append(mul(g, sub_(lump("mwnew", True),
                              add(mul(sub_(one, a1b), lump("rs2v", True)),
                                  mul(a1b, lump("mword", True))))))
        cs.append(mul(g, sub_(lump("mwnew", False),
                              add(mul(a1b, lump("rs2v", True)),
                                  mul(sub_(one, a1b),
                                      lump("mword", False))))))
        g = mul(is_store, f3(2))      # SW
        cs.append(mul(g, sub_(lump("mwnew", True), lump("rs2v", True))))
        cs.append(mul(g, sub_(lump("mwnew", False), lump("rs2v", False))))

        # --- syscall selector (SYSTEM rows; maddr carries a7) --------------
        sk = lambda i: m("sk", i)
        sk_sum = lin([(1, sk(i)) for i in range(len(SYSCALLS))])
        cs.append(sub_(sk_sum, sys))
        sk_idx = lin([(i, sk(i)) for i in range(1, len(SYSCALLS))])
        cs.append(sub_(sk_idx, mul(sys, lump("maddr", True))))
        cs.append(mul(sys, lump("maddr", False)))

        # --- SYSMEM run structure ------------------------------------------
        sm_next = sel("SYSMEM", 1)
        sys_here = sys
        sm_here = is_sm
        # a SYSMEM row follows an ecall or another SYSMEM row
        cs.append(mul(mul(sm_next, not_last),
                      sub_(one, add(sys_here, sm_here))))
        # run-start stream must match the initiating syscall
        SK_READ, SK_COMMIT, SK_KECCAK, SK_BIGINT, SK_SHA = 1, 2, 5, 6, 7
        for str_col, sk_i in ((m("sm_str", 0, 1), SK_READ),
                              (m("sm_str", 1, 1), SK_COMMIT),
                              (m("sm_str", 2, 1), SK_KECCAK),
                              (m("sm_str", 4, 1), SK_BIGINT),
                              (m("sm_str", 6, 1), SK_SHA)):
            cs.append(mul(mul(str_col, sys_here),
                          sub_(one, sk(sk_i))))
        # write streams can't start a run
        for w_slot in (3, 5, 7):
            cs.append(mul(m("sm_str", w_slot, 1), sys_here))
        # continuation keeps the stream (keccak r->w switches at rem==51)
        cs.append(mul(mul(m("sm_str", 0, 1), sm_here), sub_(one, in_w)))
        cs.append(mul(mul(m("sm_str", 1, 1), sm_here), sub_(one, j_r)))
        cs.append(mul(mul(m("sm_str", 2, 1), sm_here), sub_(one, k_r)))
        cs.append(mul(mul(m("sm_str", 3, 1), sm_here),
                      sub_(one, add(k_w, mul(k_r, m("sm_eq51"))))))
        cs.append(mul(mul(m("sm_str", 2, 1), k_r), m("sm_eq51")))
        # bigint: 36 reads (rem 48..13), then 12 writes (rem 12..1) —
        # switch after the rem==13 read row; sha: 24 reads (rem 32..9),
        # then 8 writes (rem 8..1) — switch after the rem==9 read row
        for rs, ws, rcur, eqsw in ((4, 5, b_r, "sm_eq13"),
                                   (6, 7, s_r, "sm_eq9")):
            cs.append(mul(mul(m("sm_str", rs, 1), sm_here),
                          sub_(one, rcur)))
            cs.append(mul(mul(m("sm_str", ws, 1), sm_here),
                          sub_(one, add(m("sm_str", ws),
                                        mul(rcur, m(eqsw))))))
            cs.append(mul(mul(m("sm_str", rs, 1), rcur), m(eqsw)))
        # rem bookkeeping
        rem = lin([(1 << j, m("sm_rem", j)) for j in range(20)])
        rem_next = lin([(1 << j, m("sm_rem", j, 1)) for j in range(20)])
        # eq flags (inverse trick, forced zero off SYSMEM rows)
        for eqn, eqi, delta in (("sm_eq1", "sm_eq1i", 1),
                                ("sm_eq51", "sm_eq51i", 51),
                                ("sm_eq9", "sm_eq9i", 9),
                                ("sm_eq13", "sm_eq13i", 13)):
            x = sub_(rem, ops.const(delta))
            cs.append(mul(m(eqn), x))
            cs.append(mul(is_sm, sub_(sub_(one, m(eqn)), mul(x, m(eqi)))))
            cs.append(mul(sub_(one, is_sm), m(eqn)))
        # a run ends exactly at rem==1 and continues only when rem>1
        cs.append(mul(mul(sm_here, sub_(one, mul(sm_next, not_last))),
                      sub_(rem, ops.const(1))))
        cs.append(mul(mul(sm_here, sm_next), m("sm_eq1")))
        # rem decrements along a run
        cs.append(mul(mul(sm_here, sm_next),
                      sub_(rem_next, sub_(rem, one))))
        # rem at run start: READ -> a0_out/4 (the ecall result), COMMIT ->
        # a1/4, KECCAK -> 100; high result bits are forced zero so the
        # word-count relation cannot alias mod p
        start_gate = mul(sys_here, sm_next)
        cs.append(mul(mul(start_gate, sk(SK_READ)),
                      sub_(mul(ops.const(4), rem_next), lump("res", True))))
        cs.append(mul(mul(start_gate, sk(SK_READ)), lump("res", False)))
        cs.append(mul(mul(start_gate, sk(SK_COMMIT)),
                      sub_(mul(ops.const(4), rem_next), lump("rs2v", True))))
        cs.append(mul(mul(start_gate, sk(SK_COMMIT)), lump("rs2v", False)))
        cs.append(mul(mul(start_gate, sk(SK_KECCAK)),
                      sub_(rem_next, ops.const(100))))
        cs.append(mul(mul(start_gate, sk(SK_BIGINT)),
                      sub_(rem_next, ops.const(48))))
        cs.append(mul(mul(start_gate, sk(SK_SHA)),
                      sub_(rem_next, ops.const(32))))
        # absent runs force zero IO counts (and keccak always runs)
        no_run = mul(sys_here, sub_(one, mul(sm_next, not_last)))
        cs.append(mul(mul(no_run, sk(SK_READ)), lump("res", True)))
        cs.append(mul(mul(no_run, sk(SK_READ)), lump("res", False)))
        cs.append(mul(mul(no_run, sk(SK_COMMIT)), lump("rs2v", True)))
        cs.append(mul(mul(no_run, sk(SK_COMMIT)), lump("rs2v", False)))
        cs.append(mul(no_run, sk(SK_KECCAK)))
        cs.append(mul(no_run, sk(SK_BIGINT)))
        cs.append(mul(no_run, sk(SK_SHA)))
        # base address: a0 of the ecall, propagated through the run
        cs.append(mul(start_gate, sub_(m("sm_base_l", 0, 1),
                                       lump("rs1v", True))))
        cs.append(mul(start_gate, sub_(m("sm_base_h", 0, 1),
                                       lump("rs1v", False))))
        cont_gate = mul(sm_here, sm_next)
        cs.append(mul(cont_gate, sub_(m("sm_base_l", 0, 1),
                                      m("sm_base_l"))))
        cs.append(mul(cont_gate, sub_(m("sm_base_h", 0, 1),
                                      m("sm_base_h"))))
        # address chain: run start and keccak pre->post switch reset to
        # base; stream continuations advance by 4
        maddr_lo_n = lump("maddr", True, 1)
        maddr_hi_n = lump("maddr", False, 1)
        cs.append(mul(mul(sm_next, sys_here),
                      sub_(maddr_lo_n, m("sm_base_l", 0, 1))))
        cs.append(mul(mul(sm_next, sys_here),
                      sub_(maddr_hi_n, m("sm_base_h", 0, 1))))
        cs.append(mul(mul(m("sm_str", 3, 1), k_r),
                      sub_(maddr_lo_n, m("sm_base_l", 0, 1))))
        cs.append(mul(mul(m("sm_str", 3, 1), k_r),
                      sub_(maddr_hi_n, m("sm_base_h", 0, 1))))
        # b_w/s_w follow b_r/s_r with the address continuing +4 (the
        # 32-word accelerator regions are contiguous), unlike keccak's
        # base reset
        for s_i in range(8):
            prev_same = (in_w, j_r, k_r, k_w, b_r, add(b_w, b_r),
                         s_r, add(s_w, s_r))[s_i]
            gate = mul(m("sm_str", s_i, 1), prev_same)
            cs.append(mul(gate,
                          sub_(add(lump("maddr", True), ops.const(4)),
                               add(maddr_lo_n,
                                   mul(two16m, m("sm_c", 0, 1))))))
            cs.append(mul(gate,
                          sub_(add(lump("maddr", False), m("sm_c", 0, 1)),
                               maddr_hi_n)))

        # --- memory access multiset (unsorted vs sorted) -------------------
        def fpm(wav, ts, vlo, vhi, wr, kind):
            out = cext(ops, wav)
            out = cadd(ops, out, cmul_base(ops, g5, ts))
            out = cadd(ops, out, cmul_base(ops, g5_2, vlo))
            out = cadd(ops, out, cmul_base(ops, g5_3, vhi))
            out = cadd(ops, out, cmul_base(ops, g5_4, wr))
            return cadd(ops, out, cmul_base(ops, g5_5, kind))

        wa_lo = lin([(1 << (j - 2), m("maddr", j)) for j in range(2, 18)])
        wa_hi = lin([(1 << (j - 18), m("maddr", j)) for j in range(18, 32)])
        wa = add(wa_lo, mul(ops.const(1 << 16), wa_hi))
        two_cyc = mul(ops.const(2), cyc)
        act_r = add(add(is_load, is_store),
                    add(is_memfin, add(j_r, add(k_r, add(b_r, s_r)))))
        act_w = add(add(is_store, is_meminit),
                    add(in_w, add(k_w, add(b_w, s_w))))
        fp_mr = fpm(wa, two_cyc, lump("mword", True), lump("mword", False),
                    ops.const(0), mul(ops.const(2), is_memfin))
        fp_mw = fpm(wa, add(two_cyc, one), lump("mwnew", True),
                    lump("mwnew", False), one, is_meminit)
        mu_r, mu_w = aux(A_MU), aux(A_MU + 1)
        cs.extend(csub(ops, cmul(ops, csub(ops, g4, fp_mr), mu_r),
                       cext(ops, act_r)))
        cs.extend(csub(ops, cmul(ops, csub(ops, g4, fp_mw), mu_w),
                       cext(ops, act_w)))
        for u in range(N_MEM_UNITS):
            fp_ms = fpm(m("ms_wa", u), m("ms_ts", u), m("ms_vlo", u),
                        m("ms_vhi", u), m("ms_wr", u), m("ms_kind", u))
            cs.extend(csub(ops,
                           cmul(ops, csub(ops, g4, fp_ms), aux(A_MS + u)),
                           cext(ops, m("ms_act", u))))

        def mdelta(off=0):
            d = cadd(ops, aux(A_MU, off), aux(A_MU + 1, off))
            for u in range(N_MEM_UNITS):
                d = csub(ops, d, aux(A_MS + u, off))
            return d
        macc = aux(A_MACC)
        cs.extend(cmul_base(ops, csub(ops, macc, mdelta()), isf))
        cs.extend(cmul_base(
            ops, csub(ops, aux(A_MACC, 1), cadd(ops, macc, mdelta(1))),
            not_last))
        cs.extend(cmul_base(ops, macc, isl))

        # --- sorted memory trace ordering + consistency --------------------
        inv2 = pow(2, P - 2, P)

        def is_kind2(k):
            # 1 iff kind == 2 (for kind in {0,1,2})
            return mul(ops.const(inv2), mul(k, sub_(k, one)))

        def is_kind1(k):
            # 1 iff kind == 1
            return mul(k, sub_(ops.const(2), k))

        def ms_ord_lump(u, off=0):
            return lin([(1 << j, m("ms_ord", u * MS_ORD_BITS + j, off))
                        for j in range(MS_ORD_BITS)])

        def ms_unit(u, off=0):
            return {"wa": m("ms_wa", u, off), "ts": m("ms_ts", u, off),
                    "vlo": m("ms_vlo", u, off), "vhi": m("ms_vhi", u, off),
                    "wr": m("ms_wr", u, off), "act": m("ms_act", u, off),
                    "same": m("ms_same", u, off),
                    "kind": m("ms_kind", u, off),
                    "ord": ms_ord_lump(u, off)}

        for u in range(N_MEM_UNITS):
            k = m("ms_kind", u)
            cs.append(mul(mul(k, sub_(k, one)), sub_(k, ops.const(2))))

        def mem_boundary(prev, nxt, gate_extra=None):
            actN = nxt["act"]
            if gate_extra is not None:
                actN = mul(gate_extra, actN)
            sameN = nxt["same"]
            cs.append(mul(actN, sub_(one, prev["act"])))          # prefix
            cs.append(mul(sameN, sub_(one, prev["act"])))         # same=>act
            cs.append(mul(sameN, sub_(nxt["wa"], prev["wa"])))
            d = add(mul(sameN, sub_(sub_(nxt["ts"], prev["ts"]), one)),
                    mul(sub_(one, sameN),
                        sub_(sub_(nxt["wa"], prev["wa"]), one)))
            cs.append(mul(actN, sub_(d, nxt["ord"])))
            # reads preserve the previous value
            rd_gate = mul(actN, mul(sub_(one, nxt["wr"]), sameN))
            cs.append(mul(rd_gate, sub_(nxt["vlo"], prev["vlo"])))
            cs.append(mul(rd_gate, sub_(nxt["vhi"], prev["vhi"])))
            # first access of an address must be a write (init or store)
            cs.append(mul(actN, mul(sub_(one, sameN),
                                    sub_(one, nxt["wr"]))))
            # init entries only open an address run
            cs.append(mul(sameN, is_kind1(nxt["kind"])))
            # fin entries only close one: a non-final entry can't be fin...
            cs.append(mul(sameN, is_kind2(prev["kind"])))
            # ...and the final entry of a run must be fin
            cs.append(mul(mul(prev["act"], sub_(one, sameN)),
                          sub_(prev["kind"], ops.const(2))))

        for u in range(N_MEM_UNITS - 1):
            mem_boundary(ms_unit(u), ms_unit(u + 1))
        mem_boundary(ms_unit(N_MEM_UNITS - 1), ms_unit(0, 1),
                     gate_extra=not_last)
        cs.append(mul(isf, m("ms_same", 0)))
        # on the very last row, any trailing active unit must be fin
        lastu = ms_unit(N_MEM_UNITS - 1)
        cs.append(mul(isl, mul(lastu["act"],
                               sub_(lastu["kind"], ops.const(2)))))
        u0 = ms_unit(0)
        cs.append(mul(isl, mul(mul(u0["act"], sub_(one, lastu["act"])),
                               sub_(u0["kind"], ops.const(2)))))

        # --- MEMINIT/MEMFIN list binding (derived scalars d0/d1) -----------
        d_init = challenges[7]
        d_fin = challenges[8]
        fp2_i = cadd(ops, cext(ops, wa),
                     cadd(ops, cmul_base(ops, g5, lump("mwnew", True)),
                          cmul_base(ops, g5_2, lump("mwnew", False))))
        fp2_f = cadd(ops, cext(ops, wa),
                     cadd(ops, cmul_base(ops, g5, lump("mword", True)),
                          cmul_base(ops, g5_2, lump("mword", False))))
        li, lf = aux(A_LI), aux(A_LF)
        cs.extend(csub(ops, cmul(ops, csub(ops, g4, fp2_i), li),
                       cext(ops, is_meminit)))
        cs.extend(csub(ops, cmul(ops, csub(ops, g4, fp2_f), lf),
                       cext(ops, is_memfin)))
        liacc, lfacc = aux(A_LIA), aux(A_LFA)
        cs.extend(cmul_base(ops, csub(ops, liacc, li), isf))
        cs.extend(cmul_base(ops, csub(ops, lfacc, lf), isf))
        cs.extend(cmul_base(
            ops, csub(ops, aux(A_LIA, 1), cadd(ops, liacc, aux(A_LI, 1))),
            not_last))
        cs.extend(cmul_base(
            ops, csub(ops, aux(A_LFA, 1), cadd(ops, lfacc, aux(A_LF, 1))),
            not_last))
        cs.extend(cmul_base(ops, csub(ops, liacc, d_init), isl))
        cs.extend(cmul_base(ops, csub(ops, lfacc, d_fin), isl))

        # --- IO RLC chains (challenge g6; derived finals d2/d3/d4) ---------
        g6 = challenges[6]
        g6sq = cmul(ops, g6, g6)

        def rlc_constraints(slot, act_expr, act_next, lo, lo_next,
                            hi, hi_next, final):
            r = aux(slot)
            rn = aux(slot, 1)
            absorb0 = cadd(ops, cmul_base(ops, g6, lo), cext(ops, hi))
            cs.extend(cmul_base(ops, csub(ops, r, cmul_base(ops, absorb0,
                                                            act_expr)), isf))
            absorb_n = cadd(ops, cmul(ops, r, g6sq),
                            cadd(ops, cmul_base(ops, g6, lo_next),
                                 cext(ops, hi_next)))
            keep = csub(ops, rn, r)
            step = csub(ops, rn, absorb_n)
            mix = cadd(ops, cmul_base(ops, step, act_next),
                       cmul_base(ops, keep, sub_(one, act_next)))
            cs.extend(cmul_base(ops, mix, not_last))
            cs.extend(cmul_base(ops, csub(ops, r, final), isl))

        rlc_constraints(A_RJ, j_r, m("sm_str", 1, 1),
                        lump("mword", True), lump("mword", True, 1),
                        lump("mword", False), lump("mword", False, 1),
                        challenges[9])
        k_act = add(k_r, k_w)
        k_act_n = add(m("sm_str", 2, 1), m("sm_str", 3, 1))
        k_lo = add(mul(k_r, lump("mword", True)),
                   mul(k_w, lump("mwnew", True)))
        k_lo_n = add(mul(m("sm_str", 2, 1), lump("mword", True, 1)),
                     mul(m("sm_str", 3, 1), lump("mwnew", True, 1)))
        k_hi = add(mul(k_r, lump("mword", False)),
                   mul(k_w, lump("mwnew", False)))
        k_hi_n = add(mul(m("sm_str", 2, 1), lump("mword", False, 1)),
                     mul(m("sm_str", 3, 1), lump("mwnew", False, 1)))
        rlc_constraints(A_RK, k_act, k_act_n, k_lo, k_lo_n, k_hi, k_hi_n,
                        challenges[10])
        b_act = add(b_r, b_w)
        b_act_n = add(m("sm_str", 4, 1), m("sm_str", 5, 1))
        b_lo = add(mul(b_r, lump("mword", True)),
                   mul(b_w, lump("mwnew", True)))
        b_lo_n = add(mul(m("sm_str", 4, 1), lump("mword", True, 1)),
                     mul(m("sm_str", 5, 1), lump("mwnew", True, 1)))
        b_hi = add(mul(b_r, lump("mword", False)),
                   mul(b_w, lump("mwnew", False)))
        b_hi_n = add(mul(m("sm_str", 4, 1), lump("mword", False, 1)),
                     mul(m("sm_str", 5, 1), lump("mwnew", False, 1)))
        rlc_constraints(A_RB, b_act, b_act_n, b_lo, b_lo_n, b_hi, b_hi_n,
                        challenges[11])
        s_act = add(s_r, s_w)
        s_act_n = add(m("sm_str", 6, 1), m("sm_str", 7, 1))
        s_lo = add(mul(s_r, lump("mword", True)),
                   mul(s_w, lump("mwnew", True)))
        s_lo_n = add(mul(m("sm_str", 6, 1), lump("mword", True, 1)),
                     mul(m("sm_str", 7, 1), lump("mwnew", True, 1)))
        s_hi = add(mul(s_r, lump("mword", False)),
                   mul(s_w, lump("mwnew", False)))
        s_hi_n = add(mul(m("sm_str", 6, 1), lump("mword", False, 1)),
                     mul(m("sm_str", 7, 1), lump("mwnew", False, 1)))
        rlc_constraints(A_RSH, s_act, s_act_n, s_lo, s_lo_n, s_hi, s_hi_n,
                        challenges[12])

        # --- halt / exit-code binding --------------------------------------
        # publics[4] = halted, publics[5:7] = exit code limbs
        cs.append(mul(sk(0), sub_(lump("rs1v", True), publics[5])))
        cs.append(mul(sk(0), sub_(lump("rs1v", False), publics[6])))
        # segment tail = MEMFIN/REGFIN/PAD rows; a halt row enters the
        # tail, the tail never returns to execution, and the row entering
        # the tail is a halt exactly when the halted public says so
        is_pad = sel("PAD")
        tail = add(add(sel("MEMFIN"), is_rf), is_pad)
        tail_next = add(add(sel("MEMFIN", 1), sel("REGFIN", 1)),
                        sel("PAD", 1))
        cs.append(mul(mul(sk(0), not_last), sub_(one, tail_next)))
        cs.append(mul(mul(tail, not_last), sub_(one, tail_next)))
        cs.append(mul(mul(sub_(one, tail), tail_next),
                      sub_(publics[4], sk(0))))

        # tail ordering: MEMFIN* then exactly 32 REGFIN rows then PAD+.
        # MEMFIN cannot follow REGFIN or PAD; REGFIN cannot follow PAD;
        # PAD can only start right after a REGFIN row (whose index the
        # run rules below pin to 31), and the last row is PAD — together
        # this forces every segment to read out all 32 exit registers.
        rf_next = sel("REGFIN", 1)
        pad_next = sel("PAD", 1)
        cs.append(mul(sel("MEMFIN", 1), add(is_rf, is_pad)))
        cs.append(mul(rf_next, is_pad))
        cs.append(mul(mul(pad_next, sub_(one, is_pad)), sub_(one, is_rf)))
        cs.append(mul(isl, sub_(one, is_pad)))
        # REGFIN index counter: 0 at run entry, +1 inside the run, 31 at
        # run exit
        rf_idx1 = lin([(1 << j, m("rf_idx", j, 1)) for j in range(5)])
        cs.append(mul(mul(sub_(one, is_rf), rf_next), rf_idx1))
        cs.append(mul(mul(is_rf, rf_next),
                      sub_(rf_idx1, add(rf_idx, one))))
        cs.append(mul(mul(is_rf, sub_(one, rf_next)),
                      sub_(rf_idx, ops.const(31))))

        # entry/exit register RLC chains bound to the derived scalars
        # d6/d7 (challenges 13/14): INIT rows absorb the incoming
        # register values (res), REGFIN rows the exit values (rs1v)
        rlc_constraints(A_RRE, sel("INIT"), sel("INIT", 1),
                        lump("res", True), lump("res", True, 1),
                        lump("res", False), lump("res", False, 1),
                        challenges[13])
        rlc_constraints(A_RRX, is_rf, rf_next,
                        lump("rs1v", True), lump("rs1v", True, 1),
                        lump("rs1v", False), lump("rs1v", False, 1),
                        challenges[14])

        return cs


def _imm_bit_expr(m, j):
    """Bit j of the sign-extended I-immediate as an insn-bit expression."""
    bits = _imm_bits("i")
    e = bits[j]
    return m("insn", e[1])


# ---------------------------------------------------------------------------
# Publics layout + derived scalars
# ---------------------------------------------------------------------------


def parse_publics(pubs):
    """Decode the flat segment publics (see witgen) into a dict."""
    p = [int(x) for x in pubs]
    if len(p) < 13:
        raise ValueError("publics too short")
    out = {
        "entry_pc": p[0] | (p[1] << 16),
        "exit_pc": p[2] | (p[3] << 16),
        "halted": p[4],
        "exit_code": p[5] | (p[6] << 16),
    }
    n_init, n_fin, n_j, n_k, n_b, n_s = p[7:13]
    need = 13 + 2 * 64 + 2 * (n_j + n_k + n_b + n_s)
    if len(p) != need:
        raise ValueError("bad publics length")
    # every list element is a 16-bit limb; enforcing the range here keeps
    # the host's or-compose/re-split arithmetic and the recursion
    # circuit's limb-cell arithmetic (derived_challenges_rec) identical
    if any(x < 0 or x >= (1 << 16) for x in p[13:]):
        raise ValueError("public list limb out of 16-bit range")
    off = 13

    def words(cnt):
        nonlocal off
        o = []
        for _ in range(cnt):
            o.append(p[off] | (p[off + 1] << 16))
            off += 2
        return o

    out["entry_regs"] = words(32)
    out["exit_regs"] = words(32)
    if out["entry_regs"][0] != 0 or out["exit_regs"][0] != 0:
        raise ValueError("x0 register public must be zero")
    out["n_mem"] = (n_init, n_fin)
    out["journal_words"] = words(n_j)
    out["keccak_words"] = words(n_k)
    out["bigint_words"] = words(n_b)
    out["sha_words"] = words(n_s)
    return out


def _list_sum(entries, g4, g5p):
    """sum over (addr, value) of 1/(g4 - (wa + g5*vlo + g5^2*vhi))."""
    if not entries:
        return np.zeros(4, dtype=np.uint64)
    a = np.array([e[0] for e in entries], dtype=np.uint64)
    v = np.array([e[1] for e in entries], dtype=np.uint64)
    fp = ((a >> np.uint64(2))[:, None] * g5p[0][None, :]
          + (v & np.uint64(0xFFFF))[:, None] * g5p[1][None, :]
          + (v >> np.uint64(16))[:, None] * g5p[2][None, :]) % H.PU
    inv = H.ext_inv((g4[None, :] + H.PU - fp % H.PU) % H.PU)
    return inv.sum(axis=0) % H.PU


def _rlc(words, g6):
    """Order-binding RLC over the 16-bit limb stream of `words`. The
    copy's one departure: the Horner sum in bulk (``hostmath.ext_rlc``),
    not a Python loop a limb, which takes half a minute for a keccak
    batch's 819,200 limbs; field arithmetic is exact, so the value is the
    same."""
    w = np.asarray(words, dtype=np.uint64).reshape(-1)
    limbs = np.stack([w & np.uint64(0xFFFF),
                      (w >> np.uint64(16)) & np.uint64(0xFFFF)], axis=-1)
    return H.ext_rlc(limbs.reshape(-1), g6)
