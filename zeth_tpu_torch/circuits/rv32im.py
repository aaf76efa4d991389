"""RV32IM execution circuit (AIR) v1: prove executor segments on device.

Counterpart of ``zeth_tpu.circuits.rv32im``: the layout, the AIR (control
trace, witgen, host ``build_aux``, derived challenges, constraints) and
the publics helpers are a jax-free copy of the reference's host code;
``prove_segments`` / ``prove_segment`` run on the port's torch prover,
which builds the aux group on its device with ``build_aux_device`` (the
``_dx_*`` helpers and ``_build_aux`` at the end of this module, a plain
torch composition like the reference's XLA program). The chain verifier
(``verify_segments`` / ``verify_chain``) is a copy of the reference's.

TPU-native re-design of risc0-circuit-rv32im's role (SURVEY.md §2.2):
the C++ executor (zeth_tpu_torch.executor) emits per-cycle trace records;
the numpy witgen here expands them into bit-decomposed witness columns; the
generic DEEP-ALI prover (zeth_tpu_torch.zkp) proves the constraint system.

Covered by constraints in v1:
- program binding: every non-padding row's (pc, insn) pair is looked up
  (LogUp fraction-sum argument in the aux group) in the public program
  ROM carried by the control group; the ROM is bound to the image ID.
- pc flow: one generic 32-bit adder constrains next-pc for every class
  (sequential +4, JAL/JALR targets, taken/untaken branches, frozen pc in
  padding rows), with carry columns and bit-decomposed pc.
- full ALU: ADD/SUB/ADDI, AND/OR/XOR(I), shifts (one-hot shamt unit),
  SLT(U)/SLTI(U) via a shared compare unit, LUI/AUIPC, JAL/JALR link
  values, branch conditions (BEQ/BNE/BLT(U)/BGE(U)).
- segment boundary publics: entry pc and exit pc.

Documented v1 gaps (tracked for later rounds; the reference closes these
with its memory/paging argument):
- the register file IS consistency-checked (sorted access trace + LogUp
  multiset equality + segment-entry init rows); loads still return
  unconstrained witness values and stores are uncommitted (the RAM
  argument needs executor-side access-event streaming for syscall
  memory effects — round 2).
- MUL/MULH/MULHSU/MULHU are fully constrained (8-bit-limb partial
  products with range-checked carries, signed-high adjustment), and
  DIVU/REMU verify q*b + r = a with r < b and the b == 0 special cases;
  signed DIV/REM results remain unconstrained witness values.
- ecall effects are unconstrained (journal/input binding via the claim
  is host-side only).

Max constraint degree: 4 (the prover's limit).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import field as F
from .. import hostmath as H
from ..convert import resolve_device
from ..hostmath import P
from ..zkp import proof as proof_mod
from ..zkp import prover as prover_mod
from ..zkp import verifier as verifier_mod
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

    def witgen(self, seg, po2: int) -> tuple[np.ndarray, list]:
        """Expand an executor segment -> (main_std (n, main_cols), publics).

        seg: SegmentInfo-like with .trace (cycles, 8) uint32 records
        [pc, insn, rs1v, rs2v, rdv, maddr, mword, flags], .exit_pc,
        .entry_regs, .mem_addrs/.mem_pre/.mem_post (the RAM argument's
        segment-boundary lists), .halted, .exit_code.

        Row layout: [0, 32) register init; [32, 32+n_mem) MEMINIT;
        then the executed records (instructions + SYSMEM phantom rows);
        then n_mem MEMFIN rows; then 32 REGFIN rows (exit-register
        reads, bound to the public exit-register list — cross-segment
        register continuity); rest padding.
        """
        from ..executor import (SM_BIGINT_R, SM_BIGINT_W, SM_INPUT,
                                SM_JOURNAL, SM_KECCAK_R, SM_KECCAK_W,
                                SM_SHA_R, SM_SHA_W, TR_ECALL,
                                TR_MEM_LOAD, TR_MEM_STORE, TR_SYSMEM)
        trace = seg.trace
        exit_pc = int(seg.exit_pc)
        entry_regs = seg.entry_regs
        mem_addrs = (np.asarray(seg.mem_addrs, np.uint64)
                     if seg.mem_addrs is not None else np.zeros(0, np.uint64))
        mem_pre = (np.asarray(seg.mem_pre, np.uint64)
                   if seg.mem_pre is not None else np.zeros(0, np.uint64))
        mem_post = (np.asarray(seg.mem_post, np.uint64)
                    if seg.mem_post is not None else np.zeros(0, np.uint64))
        n_mem = len(mem_addrs)

        n = 1 << po2
        rows = trace.shape[0]
        B0 = N_INIT_ROWS
        B = B0 + n_mem                   # first executed row
        BF = B + rows                    # first MEMFIN row
        B2 = BF + n_mem                  # first REGFIN row
        assert B2 + N_INIT_ROWS < n, \
            "segment does not fit (need a padding row)"
        if entry_regs is None:
            entry_regs = np.zeros(32, dtype=np.uint64)
        entry_regs = np.asarray(entry_regs, dtype=np.uint64)
        assert entry_regs[0] == 0
        exit_regs = getattr(seg, "exit_regs", None)
        if exit_regs is None:
            exit_regs = np.zeros(32, dtype=np.uint64)
        exit_regs = np.asarray(exit_regs, dtype=np.uint64)
        assert exit_regs[0] == 0
        # big segments reuse a staged buffer: a fresh (n, 1001) uint64
        # matrix page-faults at ~120 MB/s on this VM class (~18 s at
        # po2=18); the staged buffer parallel-faults once and is reused
        # for every later segment. Small (test-sized) witnesses stay
        # fresh allocations so held references never alias.
        if n >= (1 << 15):
            from .. import staging
            m = staging.staged("rv32im_witgen_main", (n, LAYOUT.n),
                               np.uint64, zero=True)
        else:
            m = np.zeros((n, LAYOUT.n), dtype=np.uint64)
        L = LAYOUT

        pc = trace[:, 0].astype(np.uint64)
        insn = trace[:, 1].astype(np.uint64)
        rs1v = trace[:, 2].astype(np.uint64)
        rs2v = trace[:, 3].astype(np.uint64)
        rdv = trace[:, 4].astype(np.uint64)
        maddr_rec = trace[:, 5].astype(np.uint64)
        mword_rec = trace[:, 6].astype(np.uint64)
        flags = trace[:, 7].astype(np.uint64)

        is_sm = (flags & np.uint64(TR_SYSMEM)) != 0
        sm_stream = (flags >> np.uint64(8)) & np.uint64(15)
        is_instr = ~is_sm

        opcode = np.where(is_instr, insn & np.uint64(0x7F), np.uint64(0))
        f3 = np.where(is_instr, (insn >> np.uint64(12)) & np.uint64(7), 0)
        b30 = (insn >> np.uint64(30)) & np.uint64(1)
        b25 = (insn >> np.uint64(25)) & np.uint64(1)

        pad_pc = np.uint64(exit_pc & 0xFFFFFFFF)

        def put_bits(name, vals, where=None):
            if where is None:
                where = slice(B, B + rows)
            s = L.slices[name]
            for j in range(s.stop - s.start):
                m[where, s.start + j] = (vals >> np.uint64(j)) & np.uint64(1)

        put_bits("pc", pc)
        put_bits("insn", insn)
        put_bits("rs1v", rs1v)
        put_bits("rs2v", rs2v)
        # the JAL/JALR link constraint (res = pc + 4) is ungated by rd_nz,
        # but the executor records rdv = 0 for rd = x0 (plain jumps `j`,
        # returns `ret`); commit the link value itself — the register-file
        # write is rd_nz-gated, so an x0 row's res is otherwise unused
        is_link = is_instr & ((opcode == 0x6F) | (opcode == 0x67))
        res_vals = np.where(is_link, (pc + np.uint64(4)) & np.uint64(0xFFFFFFFF),
                            rdv)
        put_bits("res", res_vals)
        m[BF:, L.slices["pc"].start:L.slices["pc"].stop] = (
            (pad_pc >> np.arange(32).astype(np.uint64)) & 1)
        # init + meminit rows: pc frozen at the entry pc; init rows' res
        # carries the incoming register value written by that row's unit
        first_instr = np.nonzero(is_instr)[0]
        entry_pc = np.uint64(int(trace[first_instr[0], 0])
                             if first_instr.size else int(exit_pc))
        m[:B, L.slices["pc"].start:L.slices["pc"].stop] = (
            (entry_pc >> np.arange(32).astype(np.uint64)) & 1)
        put_bits("res", entry_regs, where=slice(0, B0))

        # class selectors (flags decide SYSMEM; opcode decides the rest)
        class_of = np.full(rows, CLASS_IDX["PAD"], dtype=np.int64)
        for name, opc in CLASSES:
            if name in ("PAD", "SYSMEM", "MEMINIT", "MEMFIN", "INIT"):
                continue
            class_of[(opcode == opc) & is_instr] = CLASS_IDX[name]
        class_of[is_sm] = CLASS_IDX["SYSMEM"]
        m[B + np.arange(rows), L.idx("sel") + class_of] = 1
        m[B2 + N_INIT_ROWS:, L.idx("sel", CLASS_IDX["PAD"])] = 1
        m[:B0, L.idx("sel", CLASS_IDX["INIT"])] = 1
        m[B0:B, L.idx("sel", CLASS_IDX["MEMINIT"])] = 1
        m[BF:BF + n_mem, L.idx("sel", CLASS_IDX["MEMFIN"])] = 1
        # REGFIN rows: one exit-register read per row, index counter in
        # rf_idx, the read value committed in rs1v
        m[B2:B2 + N_INIT_ROWS, L.idx("sel", CLASS_IDX["REGFIN"])] = 1
        rf_k = np.arange(N_INIT_ROWS, dtype=np.uint64)
        for j in range(5):
            m[B2 + rf_k.astype(np.int64), L.idx("rf_idx", j)] = \
                (rf_k >> np.uint64(j)) & np.uint64(1)
        put_bits("rs1v", exit_regs, where=slice(B2, B2 + N_INIT_ROWS))

        # f3 one-hot (non-instruction rows: f3 = 0)
        m[B + np.arange(rows), L.idx("f3_sel") + f3.astype(np.int64)] = 1
        for sl in (slice(0, B), slice(BF, n)):
            m[sl, L.idx("f3_sel", 0)] = 1

        is_cls = {name: class_of == CLASS_IDX[name] for name, _ in CLASSES}

        # compare unit: a = rs1 (hi-flipped if signed), b = imm for OPIMM
        # SLTI/SLTIU else rs2 (hi-flipped if signed)
        imm_i = _imm_value("i", insn)
        signed = ((is_cls["BRANCH"] & ((f3 == 4) | (f3 == 5)))
                  | ((is_cls["OP"] | is_cls["OPIMM"]) & (f3 == 2)))
        use_imm = is_cls["OPIMM"]
        a_cmp = rs1v.copy()
        b_cmp = np.where(use_imm, imm_i, rs2v)
        flip = np.uint64(0x80000000)
        a_cmp = np.where(signed, a_cmp ^ flip, a_cmp)
        b_cmp = np.where(signed, b_cmp ^ flip, b_cmp)
        d = (a_cmp - b_cmp) & np.uint64(0xFFFFFFFF)
        put_bits("cmp_d", d)
        c1 = ((b_cmp & 0xFFFF) + (d & 0xFFFF)) >> np.uint64(16)
        m[B:B + rows, L.idx("cmp_c1")] = c1
        ltu = a_cmp < b_cmp
        m[B:B + rows, L.idx("cmp_lt")] = ltu

        # equality unit (rs1 vs rs2, per 16-bit limb)
        def inv_or_zero(x):
            out = np.zeros_like(x)
            nz = x % P != 0
            out[nz] = _vec_modinv(x[nz] % P)
            return out
        dlo = (rs1v & 0xFFFF).astype(np.int64) - (rs2v & 0xFFFF).astype(np.int64)
        dhi = (rs1v >> np.uint64(16)).astype(np.int64) - (rs2v >> np.uint64(16)).astype(np.int64)
        dlo_f = np.mod(dlo, P).astype(np.uint64)
        dhi_f = np.mod(dhi, P).astype(np.uint64)
        m[B:B + rows, L.idx("eq_lo")] = dlo_f == 0
        m[B:B + rows, L.idx("eq_hi")] = dhi_f == 0
        m[B:B + rows, L.idx("eq_inv_lo")] = inv_or_zero(dlo_f)
        m[B:B + rows, L.idx("eq_inv_hi")] = inv_or_zero(dhi_f)
        for sl in (slice(0, B), slice(BF, n)):
            m[sl, L.idx("eq_lo")] = 1
            m[sl, L.idx("eq_hi")] = 1
        # REGFIN rows carry the exit value in rs1v (rs2v = 0): the
        # ungated equality unit needs the real diff witnesses there
        x_lo = (exit_regs & np.uint64(0xFFFF)).astype(np.uint64)
        x_hi = (exit_regs >> np.uint64(16)).astype(np.uint64)
        rf_sl = slice(B2, B2 + N_INIT_ROWS)
        m[rf_sl, L.idx("eq_lo")] = x_lo == 0
        m[rf_sl, L.idx("eq_hi")] = x_hi == 0
        m[rf_sl, L.idx("eq_inv_lo")] = inv_or_zero(x_lo)
        m[rf_sl, L.idx("eq_inv_hi")] = inv_or_zero(x_hi)
        # the ungated compare adder likewise: a = rs1v, b = 0 -> d = a
        put_bits("cmp_d", exit_regs, where=rf_sl)

        # shift unit
        shamt = np.where(is_cls["OPIMM"], (insn >> np.uint64(20)) & np.uint64(31),
                         np.where(is_cls["OP"], rs2v & np.uint64(31), 0))
        is_shift = ((is_cls["OPIMM"] | (is_cls["OP"] & (b25 == 0)))
                    & ((f3 == 1) | (f3 == 5)))
        shamt = np.where(is_shift, shamt, 0)
        m[B + np.arange(rows), L.idx("sh_sel") + shamt.astype(np.int64)] = 1
        for sl in (slice(0, B), slice(BF, n)):
            m[sl, L.idx("sh_sel", 0)] = 1

        # OP-class ALU selector: excludes the M extension (funct7 bit 25)
        op_alu = (is_cls["OP"] & (b25 == 0)).astype(np.uint64)
        m[B:B + rows, L.idx("op_alu")] = op_alu

        # M-extension multiply unit (MUL/MULH/MULHSU/MULHU: f3 in 0..3)
        is_m = (is_cls["OP"] & (b25 == 1)).astype(np.uint64)
        m[B:B + rows, L.idx("is_m")] = is_m
        sdiv_rows = (is_m == 1) & ((f3 == 4) | (f3 == 6))
        div_rows = ((is_m == 1) & ((f3 == 5) | (f3 == 7))) | sdiv_rows
        mul_rows = ((is_m == 1) & (f3 <= 3)) | div_rows
        if mul_rows.any():
            ssel = sdiv_rows[mul_rows]
            # signed rows run the divide unit on absolute values
            neg32 = lambda x: (~x + np.uint64(1)) & np.uint64(0xFFFFFFFF)
            a_raw = rs1v[mul_rows]
            b_raw = rs2v[mul_rows]
            a_sign = (a_raw >> np.uint64(31)) & np.uint64(1)
            b_sign = (b_raw >> np.uint64(31)) & np.uint64(1)
            abs_a = np.where(ssel & (a_sign == 1), neg32(a_raw), a_raw)
            abs_b = np.where(ssel & (b_sign == 1), neg32(b_raw), b_raw)
            dvd = np.where(ssel, abs_a, a_raw)
            b_all = np.where(ssel, abs_b, b_raw)
            dsel = div_rows[mul_rows]
            bz = b_raw == 0
            q = np.where(bz, np.uint64(0xFFFFFFFF),
                         dvd // np.maximum(b_all, 1))
            r = np.where(bz, dvd, dvd % np.maximum(b_all, 1))
            # mul-unit A operand: rs1 for multiplies, q for divides
            a = np.where(dsel, q, a_raw)
            b = b_all
            full = a * b                       # < 2^64, fits uint64
            lo = full & np.uint64(0xFFFFFFFF)
            hi = full >> np.uint64(32)
            where = np.where(mul_rows)[0] + B
            for j in range(32):
                m[where, L.idx("mula", j)] = (a >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("mulb", j)] = (b >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("abs_a", j)] = (abs_a >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("abs_b", j)] = (abs_b >> np.uint64(j)) & np.uint64(1)
            # two's-complement relation carries (x + abs(x) = 2^32)
            sa = ssel & (a_sign == 1)
            sb = ssel & (b_sign == 1)
            m[where, L.idx("abs_ca1")] = np.where(
                sa, ((a_raw & 0xFFFF) + (abs_a & 0xFFFF)) >> np.uint64(16), 0)
            m[where, L.idx("abs_cb1")] = np.where(
                sb, ((b_raw & 0xFFFF) + (abs_b & 0xFFFF)) >> np.uint64(16), 0)
            # signed result negation carries (res + abs_res = 2^32 or 0)
            res_row = rdv[mul_rows]
            f3r_all = f3[mul_rows]
            abs_res = np.where(f3r_all == 4, q, r)
            s_neg = ssel & ~bz & np.where(
                f3r_all == 4, (a_sign ^ b_sign) == 1, a_sign == 1)
            sc1 = np.where(s_neg,
                           ((res_row & 0xFFFF) + (abs_res & 0xFFFF))
                           >> np.uint64(16), 0)
            sc2 = np.where(s_neg,
                           ((res_row >> np.uint64(16)) + (abs_res >> np.uint64(16))
                            + sc1) >> np.uint64(16), 0)
            m[where, L.idx("sneg_c1")] = sc1
            m[where, L.idx("sneg_c2")] = sc2
            # div side columns
            t = np.where(bz | ~dsel, 0, (b - r - 1) & np.uint64(0xFFFFFFFF))
            for j in range(32):
                m[where, L.idx("mdiv_q", j)] = (q >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("mdiv_r", j)] = (r >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("mdiv_t", j)] = (t >> np.uint64(j)) & np.uint64(1)
            # relation carries: qb_lo + r_lo = a_lo + 2^16 c1 (div rows, b!=0)
            c1d = np.where(dsel & ~bz,
                           ((lo & 0xFFFF) + (r & 0xFFFF)) >> np.uint64(16), 0)
            m[where, L.idx("mdiv_c1")] = c1d
            e1 = np.where(dsel & ~bz,
                          ((r & 0xFFFF) + 1 + (t & 0xFFFF)) >> np.uint64(16), 0)
            m[where, L.idx("mdiv_e1")] = e1
            # b == 0 detection per limb (on the RAW rs2, not |rs2|)
            blo = b_raw & np.uint64(0xFFFF)
            bhi = b_raw >> np.uint64(16)
            m[where, L.idx("bz_lo_eq")] = blo == 0
            m[where, L.idx("bz_hi_eq")] = bhi == 0
            m[where, L.idx("bz_lo_inv")] = inv_or_zero(blo)
            m[where, L.idx("bz_hi_inv")] = inv_or_zero(bhi)
            m[where, L.idx("div_en")] = dsel & ~bz
            m[where, L.idx("div0")] = dsel & bz
            for j in range(32):
                m[where, L.idx("mullo", j)] = (lo >> np.uint64(j)) & np.uint64(1)
                m[where, L.idx("mulhi", j)] = (hi >> np.uint64(j)) & np.uint64(1)
            # carry chain over 8-bit limbs
            al = [(a >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
            bl = [(b >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
            rl = [(full >> np.uint64(8 * k)) & np.uint64(0xFF) for k in range(8)]
            carry = np.zeros_like(a)
            for k in range(7):
                s = sum(al[i] * bl[k - i]
                        for i in range(max(0, k - 3), min(3, k) + 1))
                t = s + carry
                carry = (t - rl[k]) >> np.uint64(8)
                for j in range(12):
                    m[where, L.idx("mul_c", 12 * k + j)] =                         (carry >> np.uint64(j)) & np.uint64(1)
            # signed-high adjustment borrows for MULH / MULHSU
            f3r = f3[mul_rows]
            a31 = a >> np.uint64(31)
            b31 = b >> np.uint64(31)
            adj_lo = np.zeros_like(a)
            adj_hi = np.zeros_like(a)
            mh = f3r == 1
            adj_lo[mh] = (a31 * (b & 0xFFFF) + b31 * (a & 0xFFFF))[mh]
            adj_hi[mh] = (a31 * (b >> np.uint64(16))
                          + b31 * (a >> np.uint64(16)))[mh]
            ms = f3r == 2
            adj_lo[ms] = (a31 * (b & 0xFFFF))[ms]
            adj_hi[ms] = (a31 * (b >> np.uint64(16)))[ms]
            res_r = rdv[mul_rows]
            k1 = (adj_lo + (res_r & 0xFFFF) - (hi & 0xFFFF)) >> np.uint64(16)
            k1[~(mh | ms)] = 0
            k2 = (adj_hi + (res_r >> np.uint64(16)) + k1
                  - (hi >> np.uint64(16))) >> np.uint64(16)
            k2[~(mh | ms)] = 0
            m[where, L.idx("madj_k", 0)] = k1 & np.uint64(1)
            m[where, L.idx("madj_k", 1)] = k1 >> np.uint64(1)
            m[where, L.idx("madj_k", 2)] = k2 & np.uint64(1)
            m[where, L.idx("madj_k", 3)] = k2 >> np.uint64(1)

        # sub flag and ALU adder carries
        sub = (is_cls["OP"] & (b25 == 0) & (f3 == 0) & (b30 == 1)).astype(np.uint64)
        m[B:B + rows, L.idx("sub")] = sub
        alu_a = np.zeros(rows, dtype=np.uint64)
        alu_b = np.zeros(rows, dtype=np.uint64)
        alu_cin = np.zeros(rows, dtype=np.uint64)
        imm_u = _imm_value("u", insn)
        mm = is_cls["OPIMM"] & (f3 == 0)
        alu_a[mm], alu_b[mm] = rs1v[mm], imm_i[mm]
        mm = is_cls["OP"] & (b25 == 0) & (f3 == 0)
        alu_a[mm] = rs1v[mm]
        alu_b[mm] = np.where(sub[mm] == 1, rs2v[mm] ^ np.uint64(0xFFFFFFFF), rs2v[mm])
        alu_cin[mm] = sub[mm]
        mm = is_cls["AUIPC"]
        alu_a[mm], alu_b[mm] = pc[mm], imm_u[mm]
        mm = is_cls["JAL"] | is_cls["JALR"]
        alu_a[mm], alu_b[mm] = pc[mm], 4
        s_lo = (alu_a & 0xFFFF) + (alu_b & 0xFFFF) + alu_cin
        ac1 = s_lo >> np.uint64(16)
        s_hi = (alu_a >> np.uint64(16)) + (alu_b >> np.uint64(16)) + ac1
        m[B:B + rows, L.idx("alu_c1")] = ac1
        m[B:B + rows, L.idx("alu_c2")] = s_hi >> np.uint64(16)

        # branch taken + next-pc adder
        taken = np.zeros(rows, dtype=np.uint64)
        bm = is_cls["BRANCH"]
        eq = (rs1v == rs2v)
        cond = np.select(
            [f3 == 0, f3 == 1, f3 == 4, f3 == 5, f3 == 6, f3 == 7],
            [eq, ~eq, ltu, ~ltu, ltu, ~ltu], default=False)
        taken[bm] = cond[bm]
        m[B:B + rows, L.idx("taken")] = taken

        imm_j = _imm_value("j", insn)
        imm_b = _imm_value("b", insn)
        jalr_t = (rs1v + imm_i) & np.uint64(0xFFFFFFFF)
        lsb = np.where(is_cls["JALR"], jalr_t & 1, 0).astype(np.int64)
        m[B:B + rows, L.idx("jalr_lsb")] = lsb

        # carries for the generic next-pc adder, in *integer* limb arithmetic
        # (the JALR addend is imm_lo - lsb, which never underflows: lsb <=
        # (rs1_lo + imm_lo) & 1)
        npc_a = np.where(is_cls["JALR"], rs1v, pc)
        b_lo_int = np.select(
            [is_cls["JAL"], is_cls["JALR"], bm],
            [(imm_j & 0xFFFF).astype(np.int64),
             (imm_i & 0xFFFF).astype(np.int64) - lsb,
             np.where(taken == 1, (imm_b & 0xFFFF).astype(np.int64), 4)],
            default=4)
        b_hi_int = np.select(
            [is_cls["JAL"], is_cls["JALR"], bm],
            [(imm_j >> np.uint64(16)).astype(np.int64),
             (imm_i >> np.uint64(16)).astype(np.int64),
             np.where(taken == 1, (imm_b >> np.uint64(16)).astype(np.int64), 0)],
            default=0)
        nc1 = ((npc_a & 0xFFFF).astype(np.int64) + b_lo_int) >> 16
        nhi = (npc_a >> np.uint64(16)).astype(np.int64) + b_hi_int + nc1
        m[B:B + rows, L.idx("npc_c1")] = nc1
        m[B:B + rows, L.idx("npc_c2")] = (nhi >> 16) & 1

        # ROM multiplicities: fetch counts per image address (instruction
        # records only — SYSMEM phantom rows do not fetch)
        rom_m = np.zeros(n, dtype=np.uint64)
        addr_to_row = {int(a): i for i, a in enumerate(self.image_addrs)}
        pcs, counts = np.unique(pc[is_instr], return_counts=True)
        for a, c in zip(pcs, counts):
            row = addr_to_row.get(int(a))
            if row is None:
                raise ValueError(f"fetch from address 0x{int(a):x} outside image")
            rom_m[row] = c
        m[:, L.idx("rom_m")] = rom_m

        # --- data-memory unit columns + syscall machinery ----------------
        is_load = is_cls["LOAD"]
        is_store = is_cls["STORE"]
        is_sys = is_cls["SYSTEM"]
        put_bits("maddr", np.where(is_load | is_store | is_sm | is_sys,
                                   maddr_rec, 0))
        # addr-adder carries (loads: rs1+imm_i; stores: rs1+imm_s)
        imm_s = _imm_value("s", insn)
        mem_imm = np.where(is_load, imm_i, np.where(is_store, imm_s, 0))
        mc1 = np.where(is_load | is_store,
                       ((rs1v & 0xFFFF) + (mem_imm & 0xFFFF)) >> np.uint64(16),
                       0)
        mc2 = np.where(
            is_load | is_store,
            ((rs1v >> np.uint64(16)) + (mem_imm >> np.uint64(16)) + mc1)
            >> np.uint64(16), 0)
        m[B:B + rows, L.idx("madd_c1")] = mc1
        m[B:B + rows, L.idx("madd_c2")] = mc2 & np.uint64(1)
        # loaded/old word; byte-select one-hot
        sm_read = is_sm & ((sm_stream == SM_JOURNAL)
                           | (sm_stream == SM_KECCAK_R)
                           | (sm_stream == SM_BIGINT_R)
                           | (sm_stream == SM_SHA_R))
        sm_write = is_sm & ((sm_stream == SM_INPUT)
                            | (sm_stream == SM_KECCAK_W)
                            | (sm_stream == SM_BIGINT_W)
                            | (sm_stream == SM_SHA_W))
        put_bits("mword", np.where(is_load | is_store | sm_read,
                                   mword_rec, 0))
        bsel_rows = np.nonzero(is_load | is_store)[0]
        m[B + bsel_rows,
          L.idx("bsel") + (maddr_rec[bsel_rows] & 3).astype(np.int64)] = 1
        # merged store word
        sh_b = (maddr_rec & np.uint64(3)) * np.uint64(8)
        sh_h = (maddr_rec & np.uint64(2)) * np.uint64(8)
        mask_b = np.uint64(0xFF) << sh_b
        mask_h = np.uint64(0xFFFF) << sh_h
        store_new = np.select(
            [is_store & (f3 == 0), is_store & (f3 == 1), is_store & (f3 == 2)],
            [(mword_rec & ~mask_b) | ((rs2v & np.uint64(0xFF)) << sh_b),
             (mword_rec & ~mask_h) | ((rs2v & np.uint64(0xFFFF)) << sh_h),
             rs2v],
            default=np.uint64(0)) & np.uint64(0xFFFFFFFF)
        put_bits("mwnew", np.where(is_store, store_new,
                                   np.where(sm_write, mword_rec, 0)))
        # syscall one-hot on SYSTEM rows (maddr field carries a7)
        sys_rows = np.nonzero(is_sys)[0]
        a7 = maddr_rec[sys_rows]
        assert (a7 < len(SYSCALLS)).all(), "unknown syscall in trace"
        m[B + sys_rows, L.idx("sk") + a7.astype(np.int64)] = 1
        # SYSMEM stream one-hot + run structure (base/rem/carry/eq flags)
        stream_slot = {SM_INPUT: 0, SM_JOURNAL: 1, SM_KECCAK_R: 2,
                       SM_KECCAK_W: 3, SM_BIGINT_R: 4, SM_BIGINT_W: 5,
                       SM_SHA_R: 6, SM_SHA_W: 7}
        sm_rows = np.nonzero(is_sm)[0]
        for i in sm_rows:
            m[B + i, L.idx("sm_str", stream_slot[int(sm_stream[i])])] = 1
        # runs are maximal blocks of consecutive SYSMEM records
        i = 0
        while i < rows:
            if not is_sm[i]:
                i += 1
                continue
            j = i
            while j < rows and is_sm[j]:
                j += 1
            run = np.arange(i, j)
            base = int(maddr_rec[i])
            run_len = len(run)
            rem = run_len - np.arange(run_len)          # run_len .. 1
            m[B + run, L.idx("sm_base_l")] = base & 0xFFFF
            m[B + run, L.idx("sm_base_h")] = base >> 16
            for jbit in range(20):
                m[B + run, L.idx("sm_rem", jbit)] = (rem >> jbit) & 1
            eq1 = (rem == 1).astype(np.uint64)
            eq51 = (rem == 51).astype(np.uint64)
            eq9 = (rem == 9).astype(np.uint64)
            eq13 = (rem == 13).astype(np.uint64)
            m[B + run, L.idx("sm_eq1")] = eq1
            m[B + run, L.idx("sm_eq51")] = eq51
            m[B + run, L.idx("sm_eq9")] = eq9
            m[B + run, L.idx("sm_eq13")] = eq13
            m[B + run, L.idx("sm_eq1i")] = inv_or_zero(
                (rem.astype(np.int64) - 1) % P)
            m[B + run, L.idx("sm_eq51i")] = inv_or_zero(
                np.mod(rem.astype(np.int64) - 51, P).astype(np.uint64))
            m[B + run, L.idx("sm_eq9i")] = inv_or_zero(
                np.mod(rem.astype(np.int64) - 9, P).astype(np.uint64))
            m[B + run, L.idx("sm_eq13i")] = inv_or_zero(
                np.mod(rem.astype(np.int64) - 13, P).astype(np.uint64))
            # +4 address chain carries (on the successor row)
            for k in range(1, run_len):
                prev_a = int(maddr_rec[i + k - 1])
                if int(sm_stream[i + k]) == SM_KECCAK_W and \
                        int(sm_stream[i + k - 1]) == SM_KECCAK_R:
                    continue    # switch row: addr resets to base
                m[B + i + k, L.idx("sm_c")] = ((prev_a & 0xFFFF) + 4) >> 16
            i = j

        # MEMINIT / MEMFIN rows
        if n_mem:
            put_bits("maddr", mem_addrs, where=slice(B0, B))
            put_bits("mwnew", mem_pre, where=slice(B0, B))
            put_bits("maddr", mem_addrs, where=slice(BF, BF + n_mem))
            put_bits("mword", mem_post, where=slice(BF, BF + n_mem))

        # --- register-file access log + sorted trace ---------------------
        rd_f = np.where(is_instr, (insn >> np.uint64(7)) & np.uint64(31), 0)
        rs1_f = np.where(is_instr, (insn >> np.uint64(15)) & np.uint64(31), 0)
        rs2_f = np.where(is_instr, (insn >> np.uint64(20)) & np.uint64(31), 0)
        m[B:B + rows, L.idx("rd_nz")] = rd_f != 0
        m[B:B + rows, L.idx("rd_inv")] = inv_or_zero(rd_f)

        wb_mask = np.zeros(rows, dtype=bool)
        for name in WB_CLASSES:
            wb_mask |= is_cls[name]
        w_act = (wb_mask & (rd_f != 0)) | is_sys
        w_reg = np.where(is_sys, 10, rd_f)
        # ecall rows read a0/a1 through units 0/1 and a7 through unit 3
        r1_reg = np.where(is_sys, 10, rs1_f)
        r2_reg = np.where(is_sys, 11, rs2_f)

        # entries: (reg, ts, vlo, vhi, wr, act); ts = N_REG_UNITS*row + unit
        ex_rows = B + np.arange(rows)
        K = np.uint64(N_REG_UNITS)
        entries = []
        # init writes (rows 0..31, unit 2)
        entries.append(np.stack([
            np.arange(32, dtype=np.uint64),
            K * np.arange(32, dtype=np.uint64) + 2,
            entry_regs & np.uint64(0xFFFF), entry_regs >> np.uint64(16),
            np.ones(32, dtype=np.uint64), np.ones(32, dtype=np.uint64)],
            axis=1))
        if rows:
            act_i = is_instr.astype(np.uint64)
            entries.append(np.stack([
                r1_reg, K * ex_rows.astype(np.uint64),
                rs1v & np.uint64(0xFFFF), rs1v >> np.uint64(16),
                np.zeros(rows, dtype=np.uint64), act_i], axis=1))
            entries.append(np.stack([
                r2_reg, K * ex_rows.astype(np.uint64) + 1,
                rs2v & np.uint64(0xFFFF), rs2v >> np.uint64(16),
                np.zeros(rows, dtype=np.uint64), act_i], axis=1))
            entries.append(np.stack([
                w_reg, K * ex_rows.astype(np.uint64) + 2,
                rdv & np.uint64(0xFFFF), rdv >> np.uint64(16),
                np.ones(rows, dtype=np.uint64),
                w_act.astype(np.uint64)], axis=1))
            entries.append(np.stack([
                np.full(rows, 17, dtype=np.uint64) * is_sys,
                K * ex_rows.astype(np.uint64) + 3,
                maddr_rec & np.uint64(0xFFFF), maddr_rec >> np.uint64(16),
                np.zeros(rows, dtype=np.uint64),
                is_sys.astype(np.uint64)], axis=1))
        # exit-register reads (REGFIN rows, unit 0): the final value of
        # every register, bound to the public exit-register list
        entries.append(np.stack([
            rf_k, K * (np.uint64(B2) + rf_k),
            exit_regs & np.uint64(0xFFFF), exit_regs >> np.uint64(16),
            np.zeros(N_INIT_ROWS, dtype=np.uint64),
            np.ones(N_INIT_ROWS, dtype=np.uint64)], axis=1))
        log = np.concatenate(entries, axis=0)
        log = log[log[:, 5] == 1]                     # active only
        order = np.lexsort((log[:, 1], log[:, 0]))    # by (reg, ts)
        log = log[order]
        ne = log.shape[0]
        assert ne <= N_REG_UNITS * n
        for col, name in ((0, "m_reg"), (1, "m_cyc"), (2, "m_vlo"),
                          (3, "m_vhi"), (4, "m_wr"), (5, "m_act")):
            flat = np.zeros(N_REG_UNITS * n, dtype=np.uint64)
            flat[:ne] = log[:, col]
            for u in range(N_REG_UNITS):
                m[:, L.idx(name, u)] = flat[u::N_REG_UNITS]
        same = np.zeros(N_REG_UNITS * n, dtype=np.uint64)
        if ne > 1:
            same[1:ne] = log[1:, 0] == log[:-1, 0]
        ordb = np.zeros(N_REG_UNITS * n, dtype=np.uint64)
        if ne > 1:
            d = np.where(same[1:ne] == 1,
                         log[1:, 1] - log[:-1, 1] - 1,
                         log[1:, 0] - log[:-1, 0] - 1)
            ordb[1:ne] = d
        for u in range(N_REG_UNITS):
            m[:, L.idx("m_same", u)] = same[u::N_REG_UNITS]
            for j in range(ORD_BITS):
                m[:, L.idx("ord_bits", u * ORD_BITS + j)] = \
                    (ordb[u::N_REG_UNITS] >> np.uint64(j)) & np.uint64(1)

        # --- data-memory sorted access trace (2 units/row) ---------------
        # entries: (wa, ts, vlo, vhi, wr, kind); ts = 2*row + unit
        mem_entries = []

        def mem_entry(row_idx, unit, wa, val, wr, kind):
            mem_entries.append((int(wa), 2 * int(row_idx) + unit, int(val),
                                int(wr), int(kind)))

        for i in np.nonzero(is_load)[0]:
            mem_entry(B + i, 0, maddr_rec[i] >> 2, mword_rec[i], 0, 0)
        for i in np.nonzero(is_store)[0]:
            mem_entry(B + i, 0, maddr_rec[i] >> 2, mword_rec[i], 0, 0)
            mem_entry(B + i, 1, maddr_rec[i] >> 2, store_new[i], 1, 0)
        for i in np.nonzero(sm_read)[0]:
            mem_entry(B + i, 0, maddr_rec[i] >> 2, mword_rec[i], 0, 0)
        for i in np.nonzero(sm_write)[0]:
            mem_entry(B + i, 1, maddr_rec[i] >> 2, mword_rec[i], 1, 0)
        for k in range(n_mem):
            mem_entry(B0 + k, 1, mem_addrs[k] >> np.uint64(2), mem_pre[k],
                      1, 1)
            mem_entry(BF + k, 0, mem_addrs[k] >> np.uint64(2), mem_post[k],
                      0, 2)
        mem_entries.sort(key=lambda e: (e[0], e[1]))
        nm = len(mem_entries)
        assert nm <= N_MEM_UNITS * n
        ml = np.array(mem_entries, dtype=np.uint64).reshape(nm, 5) \
            if nm else np.zeros((0, 5), dtype=np.uint64)
        for col, name in ((0, "ms_wa"), (1, "ms_ts"), (3, "ms_wr"),
                          (4, "ms_kind")):
            flat = np.zeros(N_MEM_UNITS * n, dtype=np.uint64)
            flat[:nm] = ml[:, col]
            for u in range(N_MEM_UNITS):
                m[:, L.idx(name, u)] = flat[u::N_MEM_UNITS]
        for part, name in ((ml[:, 2] & np.uint64(0xFFFF), "ms_vlo"),
                           ((ml[:, 2] >> np.uint64(16)), "ms_vhi")):
            flat = np.zeros(N_MEM_UNITS * n, dtype=np.uint64)
            flat[:nm] = part
            for u in range(N_MEM_UNITS):
                m[:, L.idx(name, u)] = flat[u::N_MEM_UNITS]
        flat = np.zeros(N_MEM_UNITS * n, dtype=np.uint64)
        flat[:nm] = 1
        for u in range(N_MEM_UNITS):
            m[:, L.idx("ms_act", u)] = flat[u::N_MEM_UNITS]
        msame = np.zeros(N_MEM_UNITS * n, dtype=np.uint64)
        if nm > 1:
            msame[1:nm] = ml[1:, 0] == ml[:-1, 0]
        mordb = np.zeros(N_MEM_UNITS * n, dtype=np.uint64)
        if nm > 1:
            d = np.where(msame[1:nm] == 1,
                         ml[1:, 1] - ml[:-1, 1] - 1,
                         ml[1:, 0] - ml[:-1, 0] - 1)
            mordb[1:nm] = d
        for u in range(N_MEM_UNITS):
            m[:, L.idx("ms_same", u)] = msame[u::N_MEM_UNITS]
            for j in range(MS_ORD_BITS):
                m[:, L.idx("ms_ord", u * MS_ORD_BITS + j)] = \
                    (mordb[u::N_MEM_UNITS] >> np.uint64(j)) & np.uint64(1)

        # --- publics ------------------------------------------------------
        entry_pc_i = int(entry_pc)
        halted = 1 if getattr(seg, "halted", False) else 0
        exit_code = int(getattr(seg, "exit_code", 0))
        journal_words = [int(w) for w in mword_rec[is_sm & (sm_stream == SM_JOURNAL)]]
        keccak_words = [int(w) for w in mword_rec[
            is_sm & ((sm_stream == SM_KECCAK_R) | (sm_stream == SM_KECCAK_W))]]
        bigint_words = [int(w) for w in mword_rec[
            is_sm & ((sm_stream == SM_BIGINT_R) | (sm_stream == SM_BIGINT_W))]]
        sha_words = [int(w) for w in mword_rec[
            is_sm & ((sm_stream == SM_SHA_R) | (sm_stream == SM_SHA_W))]]
        publics = [entry_pc_i & 0xFFFF, entry_pc_i >> 16,
                   int(pad_pc) & 0xFFFF, int(pad_pc) >> 16,
                   halted, exit_code & 0xFFFF, exit_code >> 16,
                   n_mem, n_mem, len(journal_words), len(keccak_words),
                   len(bigint_words), len(sha_words)]
        for v in entry_regs:
            publics += [int(v) & 0xFFFF, int(v) >> 16]
        for v in exit_regs:
            publics += [int(v) & 0xFFFF, int(v) >> 16]
        # the MEMINIT/MEMFIN lists are NOT public: their LogUp sums
        # (derived scalars d0/d1) are bound by the companion paging
        # proof against the memory page-tree roots (circuits/paging.py)
        for w in journal_words + keccak_words + bigint_words + sha_words:
            publics += [w & 0xFFFF, w >> 16]
        return m, publics

    # -- aux (LogUp) -------------------------------------------------------

    def build_aux(self, main_std, challenges):
        g0 = H.ext(np.asarray(challenges[0], np.uint64))
        g1 = H.ext(np.asarray(challenges[1], np.uint64))
        main_std = np.asarray(main_std, np.uint64)
        n = main_std.shape[0]
        L = LAYOUT
        PU = np.uint64(P)

        def lump(name, lo=True):
            s = L.slices[name]
            bits = main_std[:, s.start:s.stop]
            r = range(0, 16) if lo else range(16, 32)
            out = np.zeros(n, dtype=np.uint64)
            for j in r:
                out += bits[:, j] << np.uint64(j % 16)
            return out

        def key4(vals, g):
            """sum_k g^k * vals[k] -> (n, 4) ext array (vals: base vectors)."""
            gp = H.ext_powers(g, 4)
            out = np.zeros((n, 4), dtype=np.uint64)
            for k in range(4):
                out = (out + vals[k][:, None] * gp[k][None, :]) % PU
            return out

        key_f = key4([lump("pc", True), lump("pc", False),
                      lump("insn", True), lump("insn", False)], g1)
        ctrl = self.control_trace(int(np.log2(n)))
        key_r = key4([ctrl[:, C_ROM_ALO], ctrl[:, C_ROM_AHI],
                      ctrl[:, C_ROM_WLO], ctrl[:, C_ROM_WHI]], g1)

        active = (1 - main_std[:, L.idx("sel", CLASS_IDX["PAD"])]
                  - main_std[:, L.idx("sel", CLASS_IDX["INIT"])]
                  - main_std[:, L.idx("sel", CLASS_IDX["SYSMEM"])]
                  - main_std[:, L.idx("sel", CLASS_IDX["MEMINIT"])]
                  - main_std[:, L.idx("sel", CLASS_IDX["MEMFIN"])]
                  - main_std[:, L.idx("sel", CLASS_IDX["REGFIN"])])
        rom_m = main_std[:, L.idx("rom_m")]

        inv_f = H.ext_inv((g0[None, :] + PU - key_f) % PU)
        inv_r = H.ext_inv((g0[None, :] + PU - key_r) % PU)
        t = active[:, None] * inv_f % PU
        u = rom_m[:, None] * inv_r % PU
        # running sums: values < p < 2^31, n <= 2^21 -> fits uint64
        acc = np.cumsum((t + PU - u) % PU, axis=0) % PU

        # --- register-file argument terms (challenges g2, g3) -------------
        g2 = H.ext(np.asarray(challenges[2], np.uint64))
        g3 = H.ext(np.asarray(challenges[3], np.uint64))
        g3p = H.ext_powers(g3, 5)
        cyc = np.arange(n, dtype=np.uint64)
        sel = lambda nm: main_std[:, L.idx("sel", CLASS_IDX[nm])]
        bits = lambda nm, lo, hi: sum(
            (main_std[:, L.idx(nm, j)] << np.uint64(j - lo))
            for j in range(lo, hi))

        def fingerprint(parts, gp):
            out = np.zeros((n, 4), dtype=np.uint64)
            for k, base in enumerate(parts):
                b = (np.broadcast_to(base, (n,)) % PU).astype(np.uint64)
                out = (out + b[:, None] * gp[k][None, :]) % PU
            return out

        def term(gamma, fp_vals, act):
            inv = H.ext_inv((gamma[None, :] + PU - fp_vals % PU) % PU)
            return (act % PU)[:, None] * inv % PU

        def fp(reg, ts, vlo, vhi, wr):
            return fingerprint((reg, ts, vlo, vhi, wr), g3p)

        is_init = sel("INIT")
        is_sys = sel("SYSTEM")
        K = np.uint64(N_REG_UNITS)
        rs1_f = bits("insn", 15, 20)
        rs2_f = bits("insn", 20, 25)
        rd_f = bits("insn", 7, 12)
        rd_nz = main_std[:, L.idx("rd_nz")]
        maddr_lo = bits("maddr", 0, 16)
        maddr_hi = bits("maddr", 16, 32)
        wb = sum(sel(nm) for nm in WB_CLASSES)
        w_act = (wb * rd_nz + is_sys) % PU
        w_reg = (wb * rd_nz % P * rd_f + is_sys * 10 + is_init * cyc) % PU
        w_act_all = (w_act + is_init) % PU
        is_rf = sel("REGFIN")
        rf_idx = bits("rf_idx", 0, 5)
        r1_reg = (rs1_f + is_sys * 10 + is_rf * rf_idx) % PU
        r2_reg = (rs2_f + is_sys * 11) % PU      # ecall rows read a1

        t_r1 = term(g2, fp(r1_reg, K * cyc, bits("rs1v", 0, 16),
                           bits("rs1v", 16, 32), 0), (active + is_rf) % PU)
        t_r2 = term(g2, fp(r2_reg, K * cyc + 1, bits("rs2v", 0, 16),
                           bits("rs2v", 16, 32), 0), active)
        t_w = term(g2, fp(w_reg, K * cyc + 2, bits("res", 0, 16),
                          bits("res", 16, 32), 1), w_act_all)
        t_a7 = term(g2, fp(17 * is_sys, K * cyc + 3, maddr_lo, maddr_hi, 0),
                    is_sys)
        s_terms = []
        for u2 in range(N_REG_UNITS):
            s_terms.append(term(
                g2,
                fp(main_std[:, L.idx("m_reg", u2)],
                   main_std[:, L.idx("m_cyc", u2)],
                   main_std[:, L.idx("m_vlo", u2)],
                   main_std[:, L.idx("m_vhi", u2)],
                   main_std[:, L.idx("m_wr", u2)]),
                main_std[:, L.idx("m_act", u2)]))
        delta = (t_r1 + t_r2 + t_w + t_a7 + 4 * PU
                 - s_terms[0] - s_terms[1] - s_terms[2] - s_terms[3]) % PU
        racc = np.cumsum(delta, axis=0) % PU

        # --- data-memory argument terms (challenges g4, g5) ---------------
        g4 = H.ext(np.asarray(challenges[4], np.uint64))
        g5 = H.ext(np.asarray(challenges[5], np.uint64))
        g5p = H.ext_powers(g5, 6)
        is_load = sel("LOAD")
        is_store = sel("STORE")
        is_meminit = sel("MEMINIT")
        is_memfin = sel("MEMFIN")
        smc = lambda k: main_std[:, L.idx("sm_str", k)]
        in_w, j_r, k_r, k_w = smc(0), smc(1), smc(2), smc(3)
        b_r, b_w, sh_r, sh_w = smc(4), smc(5), smc(6), smc(7)
        wa = bits("maddr", 2, 32)
        mword_lo, mword_hi = bits("mword", 0, 16), bits("mword", 16, 32)
        mwnew_lo, mwnew_hi = bits("mwnew", 0, 16), bits("mwnew", 16, 32)

        def fpm(wav, ts, vlo, vhi, wr, kind):
            return fingerprint((wav, ts, vlo, vhi, wr, kind), g5p)

        act_r = (is_load + is_store + is_memfin + j_r + k_r + b_r
                 + sh_r) % PU
        act_w = (is_store + is_meminit + in_w + k_w + b_w + sh_w) % PU
        mu_r = term(g4, fpm(wa, 2 * cyc, mword_lo, mword_hi, 0,
                            2 * is_memfin), act_r)
        mu_w = term(g4, fpm(wa, 2 * cyc + 1, mwnew_lo, mwnew_hi, 1,
                            is_meminit), act_w)
        msort = []
        for u2 in range(N_MEM_UNITS):
            msort.append(term(
                g4,
                fpm(main_std[:, L.idx("ms_wa", u2)],
                    main_std[:, L.idx("ms_ts", u2)],
                    main_std[:, L.idx("ms_vlo", u2)],
                    main_std[:, L.idx("ms_vhi", u2)],
                    main_std[:, L.idx("ms_wr", u2)],
                    main_std[:, L.idx("ms_kind", u2)]),
                main_std[:, L.idx("ms_act", u2)]))
        mdelta = (mu_r + mu_w + 2 * PU - msort[0] - msort[1]) % PU
        macc = np.cumsum(mdelta, axis=0) % PU

        # --- MEMINIT/MEMFIN list-binding sums -----------------------------
        fp2_i = fingerprint((wa, mwnew_lo, mwnew_hi), g5p)
        fp2_f = fingerprint((wa, mword_lo, mword_hi), g5p)
        li = term(g4, fp2_i, is_meminit)
        lf = term(g4, fp2_f, is_memfin)
        liacc = np.cumsum(li, axis=0) % PU
        lfacc = np.cumsum(lf, axis=0) % PU

        # --- IO RLC chains (challenge g6) ---------------------------------
        g6 = H.ext(np.asarray(challenges[6], np.uint64))
        g6sq = H.ext_mul(g6, g6)

        def rlc_chain(act_mask, lo_vals, hi_vals):
            col = np.zeros((n, 4), dtype=np.uint64)
            r = np.zeros(4, dtype=np.uint64)
            idxs = np.nonzero(np.asarray(act_mask, np.uint64))[0]
            prev = 0
            for i in idxs:
                col[prev:i] = r
                r = H.ext_add(H.ext_mul(r, g6sq),
                              H.ext_add(H.ext_mul(H.ext(int(lo_vals[i])), g6),
                                        H.ext(int(hi_vals[i]))))
                prev = i
                col[i] = r
                prev = i + 1
            col[prev:] = r
            return col

        r_j = rlc_chain(j_r, mword_lo, mword_hi)
        kact = (k_r + k_w) % PU
        k_lo = (k_r * mword_lo + k_w * mwnew_lo) % PU
        k_hi = (k_r * mword_hi + k_w * mwnew_hi) % PU
        r_k = rlc_chain(kact, k_lo, k_hi)
        bact = (b_r + b_w) % PU
        b_lo = (b_r * mword_lo + b_w * mwnew_lo) % PU
        b_hi = (b_r * mword_hi + b_w * mwnew_hi) % PU
        r_b = rlc_chain(bact, b_lo, b_hi)
        shact = (sh_r + sh_w) % PU
        sh_lo = (sh_r * mword_lo + sh_w * mwnew_lo) % PU
        sh_hi = (sh_r * mword_hi + sh_w * mwnew_hi) % PU
        r_sh = rlc_chain(shact, sh_lo, sh_hi)

        # --- entry/exit register RLC chains (challenge g6) ----------------
        res_lo, res_hi = bits("res", 0, 16), bits("res", 16, 32)
        rs1_lo, rs1_hi = bits("rs1v", 0, 16), bits("rs1v", 16, 32)
        r_re = rlc_chain(is_init, res_lo, res_hi)
        r_rx = rlc_chain(is_rf, rs1_lo, rs1_hi)

        aux = np.concatenate(
            [t, u, acc, t_r1, t_r2, t_w, t_a7,
             s_terms[0], s_terms[1], s_terms[2], s_terms[3], racc,
             mu_r, mu_w, msort[0], msort[1], macc,
             li, lf, liacc, lfacc, r_j, r_k, r_b, r_sh, r_re, r_rx],
            axis=1)
        assert aux.shape == (n, N_AUX)
        return aux

    def build_aux_device(self, main_dev_std, ctrl_dev_std, challenges):
        """Device twin of build_aux: the LogUp/permutation accumulator
        columns computed from the standard-form main and control tensors
        that are already on the device (no (n, aux) host matrix, no
        second upload). Returns Montgomery form, equal word for word to
        the host path, which stays the oracle and serves AIRs without a
        device twin."""
        chal = np.asarray(challenges, np.uint64)[:7].astype(np.int64)
        return _build_aux(main_dev_std, ctrl_dev_std,
                          torch.from_numpy(chal).to(main_dev_std.device))

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

    def publics_shape(self, publics):
        """Shape token for the lift-program cache (the list counts)."""
        pp = parse_publics([int(p) for p in publics])
        return (len(pp["journal_words"]), len(pp["keccak_words"]),
                len(pp["bigint_words"]), len(pp["sha_words"]))

    def derived_challenges_rec(self, b, pub_cells, chal_ext, pub_shape,
                               extra_cells=None):
        """In-circuit mirror of derived_challenges for the lift program.

        Replays _rlc over the public list cells; d0/d1 arrive as extra
        witness cells (bound into the lift claim and resolved against
        the companion paging proof's publics at the receipt level). The
        in-proof counts are asserted equal to the compiled shape
        (parse_publics pins all list limbs to 16 bits, making
        or-compose equal to addition on both sides).
        """
        n_j, n_k, n_b, n_s = pub_shape
        for j, cnt in ((9, n_j), (10, n_k), (11, n_b), (12, n_s)):
            b.assert_eq(pub_cells[j], cnt)
        g6 = chal_ext[6]
        off = 13

        def rlc(cnt):
            nonlocal off
            acc = b.ZERO
            for _ in range(cnt):
                lo, hi = pub_cells[off:off + 2]
                off += 2
                acc = b.fma(a=acc, b=g6, c=lo, d=b.ONE, s0=1, s1=1)
                acc = b.fma(a=acc, b=g6, c=hi, d=b.ONE, s0=1, s1=1)
            return acc

        d6 = rlc(32)     # entry-register list
        d7 = rlc(32)     # exit-register list
        d0 = extra_cells["d0"]
        d1 = extra_cells["d1"]
        d2 = rlc(n_j)
        d3 = rlc(n_k)
        d4 = rlc(n_b)
        d5 = rlc(n_s)
        assert off == len(pub_cells)
        return [d0, d1, d2, d3, d4, d5, d6, d7]

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


def _vec_modinv(x: np.ndarray) -> np.ndarray:
    """Vectorized modular inverse via x^(p-2) (numpy uint64)."""
    x = x.astype(np.uint64) % np.uint64(P)
    result = np.ones_like(x)
    base = x.copy()
    e = P - 2
    while e:
        if e & 1:
            result = result * base % np.uint64(P)
        base = base * base % np.uint64(P)
        e >>= 1
    return result


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
    """Order-binding RLC over the 16-bit limb stream of `words`."""
    if not words:
        return np.zeros(4, dtype=np.uint64)
    limbs = []
    for w in words:
        limbs += [w & 0xFFFF, (w >> 16) & 0xFFFF]
    k = len(limbs)
    gp = H.ext_powers(g6, k)
    acc = np.zeros(4, dtype=np.uint64)
    for i, limb in enumerate(limbs):
        acc = (acc + np.uint64(limb) * gp[k - 1 - i]) % H.PU
    return acc


# ---------------------------------------------------------------------------
# Segment prove / verify (zkvm.LocalProver entry points)
# ---------------------------------------------------------------------------


def _air_for_image(image_addrs, image_words) -> Rv32imAir:
    return Rv32imAir(image_addrs, image_words)


def choose_po2(seg, image_len: int) -> int:
    rows = seg.trace.shape[0]
    n_mem = 0 if seg.mem_addrs is None else len(seg.mem_addrs)
    need = max(rows + 2 * N_INIT_ROWS + 2 * n_mem + 1, image_len, 128)
    return max(int(np.ceil(np.log2(need))), 7)


def prove_segments(segments, image_addrs, image_words, device=None,
                   mesh=None):
    """Prove a chain of executor segments on `device` (None: the CUDA
    card; without one the call raises).

    Returns (seals, paging_seals): per segment, the rv32im STARK seal
    and its companion paging seal (circuits/paging.py). The paging main
    trace is committed FIRST and mixed into the rv32im transcript
    (extra_mix) so the page/touch witness predates the sampling of the
    RAM challenges g4/g5; the d0/d1 boundary sums are then computed under
    the sampled challenges and bound in both proofs. The paging proof is
    proved inline, from the challenge callback (the two transcripts are
    independent, so the seals equal the reference's, which proves it on
    a worker thread).

    mesh: every rank of a ``rows`` mesh calls this with the same
    segments; the rv32im proofs are sharded over the ranks
    (``prover.prove(mesh=...)``). The paging companion stays unsharded,
    as in the reference: rank 0 alone builds its witness, commits and
    proves it, and broadcasts its root (before the rv32im transcript
    needs it) and its seal. Every rank returns the same seals.
    """
    from ..hash import pagetree as PT_
    from ..parallel import comm
    from . import paging as paging_mod
    device = resolve_device(device, mesh)
    lead = mesh is None or comm.rank(mesh) == 0
    air = _air_for_image(image_addrs, image_words)
    pg_air = paging_mod.PagingAir()
    tree = PT_.SparsePageTree(image_addrs, image_words) if lead else None
    zero4 = np.zeros(4, np.uint64)
    seals, pg_seals = [], []
    for seg in segments:
        pn = prep = postp = tch = r0 = r1 = pg_main = pg_commit = None
        pg_root = None
        with prover_mod._Stage("paging witness + commit", device):
            if lead:
                pn, prep, postp, tch, sibs, r0, r1 = \
                    paging_mod.segment_witness(tree, seg.mem_addrs,
                                               seg.mem_pre, seg.mem_post)
                # the paging MAIN trace is independent of its publics;
                # commit it first so its root can pre-seed the rv32im
                # transcript
                pg_main, _ = pg_air.witgen(pn, prep, postp, tch, sibs, r0,
                                           r1, zero4, zero4)
                pg_root, pg_commit = prover_mod.commit_main(pg_air, pg_main,
                                                            device)
            if mesh is not None:
                pg_root = comm.broadcast_object(pg_root, mesh)

        with prover_mod._Stage("rv32im witgen (host)", device):
            po2 = choose_po2(seg, len(image_addrs))
            main, publics = air.witgen(seg, po2)
        init_list = [(int(a), int(v))
                     for a, v in zip(seg.mem_addrs, seg.mem_pre)]
        fin_list = [(int(a), int(v))
                    for a, v in zip(seg.mem_addrs, seg.mem_post)]
        done = {}

        def dx(sampled, done=done, init_list=init_list, fin_list=fin_list,
               pn=pn, prep=prep, postp=postp, tch=tch, r0=r0, r1=r1,
               pg_main=pg_main, pg_commit=pg_commit):
            g4 = H.ext(np.asarray(sampled[4], np.uint64))
            g5 = H.ext(np.asarray(sampled[5], np.uint64))
            if lead:
                with prover_mod._Stage("paging touch sums (host)", device):
                    pg_pubs = paging_mod.PagingAir.pack_publics(
                        sampled[4], sampled[5], r0, r1,
                        paging_mod._touch_sum(pn, prep, tch, sampled[4],
                                              sampled[5]),
                        paging_mod._touch_sum(pn, postp, tch, sampled[4],
                                              sampled[5]))
                with prover_mod._Stage("paging prove", device):
                    done["pg"] = proof_mod.encode(prover_mod.prove(
                        pg_air, pg_main, pg_pubs, main_commit=pg_commit,
                        device=device))
            g5p = H.ext_powers(g5, 3)
            with prover_mod._Stage("boundary list sums (host)", device):
                return {"d0": _list_sum(init_list, g4, g5p),
                        "d1": _list_sum(fin_list, g4, g5p)}

        with prover_mod._Stage("rv32im prove", device):
            proof = prover_mod.prove(air, main, publics, derived_extra=dx,
                                     extra_mix=pg_root, device=device,
                                     mesh=mesh)
        seals.append(proof_mod.encode(proof))
        pg_seal = done.get("pg")
        if mesh is not None:
            pg_seal = comm.broadcast_object(pg_seal, mesh)
        assert (np.asarray(proof_mod.decode(pg_seal).roots["main"],
                           np.uint64) == pg_root).all()
        pg_seals.append(pg_seal)
    return seals, pg_seals


def prove_segment(seg, image_addrs, image_words, device=None, mesh=None):
    """Prove one executor segment starting from the pristine image
    (single-segment guests / benches) on `device` (None: the CUDA card);
    returns (seal, paging_seal). `mesh`: as ``prove_segments``."""
    seals, pg_seals = prove_segments([seg], image_addrs, image_words, device,
                                     mesh)
    return seals[0], pg_seals[0]


def verify_chain(publics_list, claim, image_addrs, image_words,
                 entry_pc: int, paging_publics_list=None,
                 keccak_checked: bool = False,
                 bigint_checked: bool = False,
                 sha_checked: bool = False) -> dict:
    """Chain checks over per-segment publics (no STARK verification).

    Checks: pc continuity; register continuity (entry/exit register
    lists); RAM continuity via the paging proofs' memory page-tree
    roots (segment 0's pre_root is the image's page root; each
    post_root is the next segment's pre_root — the reference's
    MemoryImage digest chaining); keccak/bigint accelerator IO
    (recomputed host-side from the bound operands unless `*_checked` —
    i.e. an accelerator proof covers it, the resolve path); and, across
    the chain: exactly the final segment halts, with the claim's exit
    code, and the concatenated journal words hash to the claim's journal
    digest (the reference's journal commitment,
    guests/stateless-client/src/lib.rs:33).

    paging_publics_list: per-segment paging-proof publics (the caller —
    verify_segments / the receipt path — must have STARK-verified the
    paging seals and their cross-binding to the rv32im proofs).
    """
    import hashlib

    from ..executor import image_page_root
    from ..hash.keccak import permute_np as keccak_permute
    from ..zkvm import VerificationError
    from .paging import PagingAir
    expect_pc = int(entry_pc)
    if not publics_list:
        raise VerificationError("no segments")
    if paging_publics_list is None or \
            len(paging_publics_list) != len(publics_list):
        raise VerificationError("paging publics missing for the chain")
    expect_root = image_page_root(image_addrs, image_words)
    expect_regs = [0] * 32    # machine registers start zeroed
    journal_words: list[int] = []
    keccak_words: list[int] = []
    bigint_words: list[int] = []
    sha_words: list[int] = []
    for i, pubs in enumerate(publics_list):
        try:
            pp = parse_publics([int(p) for p in pubs])
        except ValueError as e:
            raise VerificationError(f"segment {i}: {e}") from e
        if pp["entry_pc"] != expect_pc:
            raise VerificationError(f"segment {i}: entry pc mismatch")
        # register continuity: the segment's entry registers must match
        # the previous segment's exit registers (zeros for segment 0)
        if pp["entry_regs"] != expect_regs:
            raise VerificationError(
                f"segment {i}: entry registers do not match the previous "
                "segment's exit registers")
        expect_regs = pp["exit_regs"]
        last = i == len(publics_list) - 1
        if bool(pp["halted"]) != last:
            raise VerificationError(
                f"segment {i}: halt flag mismatch (only the final segment "
                "halts)")
        if last and pp["exit_code"] != int(claim.exit_code):
            raise VerificationError("exit code does not match claim")
        # RAM continuity: the paging proofs' page-tree roots chain from
        # the image root through every segment
        try:
            ppg = PagingAir.parse_publics(paging_publics_list[i])
        except ValueError as e:
            raise VerificationError(f"segment {i} paging: {e}") from e
        if not (ppg["pre_root"] == expect_root).all():
            raise VerificationError(
                f"segment {i}: paging pre-root does not chain")
        expect_root = ppg["post_root"]
        # keccak accelerator IO: recompute f[1600] over the bound states
        # unless an accelerator proof discharges them (resolve)
        kw = pp["keccak_words"]
        if len(kw) % 100:
            raise VerificationError(f"segment {i}: bad keccak IO length")
        if not keccak_checked:
            for c in range(0, len(kw), 100):
                pre = np.zeros(25, dtype=np.uint64)
                post = np.zeros(25, dtype=np.uint64)
                for j in range(25):
                    pre[j] = kw[c + 2 * j] | (kw[c + 2 * j + 1] << 32)
                    post[j] = kw[c + 50 + 2 * j] | (kw[c + 50 + 2 * j + 1] << 32)
                got = keccak_permute(pre[None])[0]
                if not (got == post).all():
                    raise VerificationError(
                        f"segment {i}: keccak accelerator output mismatch")
        keccak_words += kw
        # bigint accelerator IO: recompute a*b mod m over the bound
        # operands unless an accelerator proof discharges them (resolve)
        bw = pp["bigint_words"]
        if len(bw) % 48:
            raise VerificationError(f"segment {i}: bad bigint IO length")
        if not bigint_checked:
            for c in range(0, len(bw), 48):
                vals = [sum(bw[c + 12 * j + w] << (32 * w)
                            for w in range(12))
                        for j in range(4)]
                a, b, mm, r = vals
                if mm == 0 or r != a * b % mm:
                    raise VerificationError(
                        f"segment {i}: bigint accelerator result mismatch")
        bigint_words += bw
        # sha-256 accelerator IO: recompute the compression over the
        # bound operands unless an accelerator proof discharges them
        sw = pp["sha_words"]
        if len(sw) % 32:
            raise VerificationError(f"segment {i}: bad sha IO length")
        if not sha_checked:
            for c in range(0, len(sw), 32):
                if _sha_compress_words(sw[c:c + 8], sw[c + 8:c + 24]) \
                        != sw[c + 24:c + 32]:
                    raise VerificationError(
                        f"segment {i}: sha accelerator result mismatch")
        sha_words += sw
        journal_words += pp["journal_words"]
        expect_pc = pp["exit_pc"]
    journal = b"".join(int(w).to_bytes(4, "little") for w in journal_words)
    if hashlib.sha256(journal).digest() != claim.journal_digest:
        raise VerificationError("journal does not match claim digest")
    return {"keccak_words": keccak_words, "bigint_words": bigint_words,
            "sha_words": sha_words}


def _sha_compress_words(state, block):
    """Pure-python SHA-256 compression (FIPS 180-4) for the host-side
    accelerator-IO recompute."""
    from ..hash.sha256 import _K
    M = 0xFFFFFFFF
    rotr = lambda x, n: ((x >> n) | (x << (32 - n))) & M
    w = list(block)
    for t in range(16, 64):
        s0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ (~e & g & M)
        t1 = (h + S1 + ch + int(_K[t]) + w[t]) & M
        S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M, c, b, a, (t1 + t2) & M
    return [(x + y) & M for x, y in zip(state, [a, b, c, d, e, f, g, h])]


def verify_segments(seals, paging_seals, claim, image_addrs, image_words,
                    entry_pc: int,
                    keccak_checked: bool = False,
                    bigint_checked: bool = False,
                    sha_checked: bool = False, device=None) -> dict:
    """Verify a chain of (segment, paging) seal pairs; returns the bound
    accelerator IO ({"keccak_words", "bigint_words", "sha_words"}).

    Per segment: the paging STARK (page hashes + root update + d0/d1
    binding), the rv32im STARK verified WITH the paging proof's d0/d1
    as derived scalars and its main root as the transcript pre-seed
    (extra_mix), the g4/g5 cross-check (the paging proof's public
    challenges must equal the ones the rv32im transcript sampled), then
    every chain check of verify_chain (pc/register/root continuity,
    halt/exit-code, journal digest, accelerator IO). The STARK verifies
    recompute their control roots on `device` (None: the CUDA card)."""
    from ..zkvm import VerificationError
    from .paging import PagingAir
    air = _air_for_image(image_addrs, image_words)
    pg_air = PagingAir()
    if len(paging_seals) != len(seals):
        raise VerificationError("segment/paging seal count mismatch")
    publics_list, paging_pubs_list = [], []
    for i, (seal, pseal) in enumerate(zip(seals, paging_seals)):
        proof = proof_mod.decode(seal)
        pg_proof = proof_mod.decode(pseal)
        pubs = [int(p) for p in proof.publics]
        pg_pubs = [int(p) for p in pg_proof.publics]
        try:
            ppg = PagingAir.parse_publics(pg_pubs)
            verifier_mod.verify(pg_air, pg_proof, pg_pubs, device=device)
            sampled = verifier_mod.verify(
                air, proof, pubs,
                derived_extra={"d0": ppg["d0"], "d1": ppg["d1"]},
                extra_mix=pg_proof.roots["main"], device=device)
        except verifier_mod.VerificationError as e:
            raise VerificationError(f"segment {i}: {e}") from e
        if not ((np.asarray(sampled[4], np.uint64) == ppg["g4"]).all()
                and (np.asarray(sampled[5], np.uint64) == ppg["g5"]).all()):
            raise VerificationError(
                f"segment {i}: paging proof challenges do not match the "
                "rv32im transcript")
        publics_list.append(pubs)
        paging_pubs_list.append(pg_pubs)
    return verify_chain(publics_list, claim, image_addrs, image_words,
                        entry_pc, paging_publics_list=paging_pubs_list,
                        keccak_checked=keccak_checked,
                        bigint_checked=bigint_checked,
                        sha_checked=sha_checked)


# ---------------------------------------------------------------------------
# Device aux group: the torch twin of Rv32imAir.build_aux. All
# multiplicative work happens in Montgomery form on the device; running
# sums are one int64 cumsum and one reduction; the RLC chains are
# affine-map scans in log(n) steps. Output is the Montgomery-form
# (n, N_AUX) int32 matrix (ready for the prover's coset LDE), equal word
# for word to the host path. Only the main columns that the argument
# reads are converted, so no temporary is as wide as the main group.
# ---------------------------------------------------------------------------


def _dx_lump(main, name, lo):
    """16-bit lump of a 32-bit decomposed column group -> (n,) int64."""
    s = LAYOUT.slices[name]
    base = s.start + (0 if lo else 16)
    return _dx_weigh(main[:, base:base + 16])


def _dx_bits(main, name, lo, hi):
    """Value of bits [lo, hi) of a decomposed column group -> (n,) int64."""
    s = LAYOUT.slices[name]
    return _dx_weigh(main[:, s.start + lo:s.start + hi])


def _dx_weigh(cols):
    w = torch.ones(cols.shape[1], dtype=F.I64, device=cols.device) \
        << torch.arange(cols.shape[1], device=cols.device)
    return (cols.to(F.I64) * w).sum(dim=1)


def _dx_ext_powers(g_m, k):
    """g (4,) monty -> (k, 4) monty powers g^0..g^(k-1)."""
    one = torch.zeros(4, dtype=F.I32, device=g_m.device)
    one[0] = F.mont_one()
    out = [one]
    for _ in range(k - 1):
        out.append(F.ext_mul(out[-1], g_m))
    return torch.stack(out)


def _dx_fingerprint(parts_m, gp):
    """sum_k parts[k] * g^k; parts are (n,) base monty; gp (k,4) monty."""
    acc = torch.zeros((parts_m[0].shape[0], 4), dtype=F.I32,
                      device=gp.device)
    for k, b in enumerate(parts_m):
        acc = F.ext_add(acc, F.ext_mul_base(gp[k][None, :], b))
    return acc


def _dx_term(gamma_m, fp_m, act_m):
    inv = F.ext_inv(F.ext_sub(gamma_m.expand(fp_m.shape), fp_m))
    return F.ext_mul_base(inv, act_m)


def _dx_cumsum(x):
    """Running sum along axis 0. A sum of Montgomery forms is the
    Montgomery form of the sum, and n * p < 2^53 is exact in int64."""
    return torch.fmod(torch.cumsum(x.to(F.I64), dim=0), P).to(F.I32)


def _dx_rlc_chain(act_m, val_m, g6sq_m, one_ext):
    """Affine scan along axis 0: r_i = act ? r_{i-1}*g6^2 + val_i : r_{i-1}.

    act_m: (n, ...) monty 0/1; val_m: (n, ..., 4). Inclusive scan of the
    maps x -> m*x + c under composition, in log2(n) doubling steps
    (Hillis-Steele): after the step of distance d, entry i holds the
    composition of the maps i-2d+1..i."""
    n = act_m.shape[0]
    m = torch.where(act_m[..., None] != 0, g6sq_m, one_ext)
    c = F.ext_mul_base(val_m, act_m)     # act is 0/1: keeps or zeroes val
    d = 1
    while d < n:
        c = torch.cat([c[:d], F.ext_add(F.ext_mul(m[d:], c[:-d]), c[d:])])
        if 2 * d < n:
            m = torch.cat([m[:d], F.ext_mul(m[:-d], m[d:])])
        d *= 2
    return c


def _build_aux(main, ctrl, chal_std):
    """main/ctrl: standard-form int32 device tensors; chal_std: (7, 4)
    standard-form integers. Returns the MONTGOMERY-form (n, N_AUX) aux
    matrix (feeds the coset LDE directly)."""
    n = main.shape[0]
    dev = main.device
    L = LAYOUT
    monty = F.to_monty
    ch = monty(chal_std)                 # (7, 4) monty
    one_ext = torch.zeros(4, dtype=F.I32, device=dev)
    one_ext[0] = F.mont_one()

    # standard-form int64 / Montgomery views of single main columns
    col = lambda *a: main[:, L.idx(*a)].to(F.I64)
    colm = lambda *a: monty(main[:, L.idx(*a)])
    sel = lambda nm: col("sel", CLASS_IDX[nm])
    selm = lambda nm: colm("sel", CLASS_IDX[nm])

    # --- ROM fetch argument (g0, g1) -----------------------------------
    g0, g1 = ch[0], ch[1]
    g1p = _dx_ext_powers(g1, 4)
    key_f = _dx_fingerprint(
        [monty(_dx_lump(main, "pc", True)), monty(_dx_lump(main, "pc", False)),
         monty(_dx_lump(main, "insn", True)),
         monty(_dx_lump(main, "insn", False))], g1p)
    key_r = _dx_fingerprint(
        [monty(ctrl[:, c]) for c in (C_ROM_ALO, C_ROM_AHI,
                                     C_ROM_WLO, C_ROM_WHI)], g1p)
    # the row's class selector is one-hot, so the sum is 0 or 1
    active = monty(1 - (sel("PAD") + sel("INIT") + sel("SYSMEM")
                        + sel("MEMINIT") + sel("MEMFIN") + sel("REGFIN")))
    t = _dx_term(g0, key_f, active)
    u = _dx_term(g0, key_r, colm("rom_m"))
    acc = _dx_cumsum(F.ext_sub(t, u))

    # --- register-file argument (g2, g3) --------------------------------
    g2, g3 = ch[2], ch[3]
    g3p = _dx_ext_powers(g3, 5)
    cyc = torch.arange(n, dtype=F.I64, device=dev)
    K = N_REG_UNITS
    rs1_f = _dx_bits(main, "insn", 15, 20)
    rs2_f = _dx_bits(main, "insn", 20, 25)
    rd_f = _dx_bits(main, "insn", 7, 12)
    rd_nz = col("rd_nz")
    maddr_lo = _dx_bits(main, "maddr", 0, 16)
    maddr_hi = _dx_bits(main, "maddr", 16, 32)
    is_init = sel("INIT")
    is_sys = sel("SYSTEM")
    wb = sum(sel(nm) for nm in WB_CLASSES)
    w_act = wb * rd_nz + is_sys
    # all below p: rd_f < 32, cyc < 2^21
    w_reg = wb * rd_nz * rd_f + 10 * is_sys + is_init * cyc
    w_act_all = w_act + is_init
    is_rf = sel("REGFIN")
    rf_idx = _dx_bits(main, "rf_idx", 0, 5)
    r1_reg = rs1_f + 10 * is_sys + is_rf * rf_idx
    r2_reg = rs2_f + 11 * is_sys
    zero_m = torch.zeros(n, dtype=F.I32, device=dev)
    one_m = torch.full((n,), F.mont_one(), dtype=F.I32, device=dev)
    rs1_lo = _dx_bits(main, "rs1v", 0, 16)
    rs1_hi = _dx_bits(main, "rs1v", 16, 32)
    res_lo = _dx_bits(main, "res", 0, 16)
    res_hi = _dx_bits(main, "res", 16, 32)

    def fp(reg, ts, vlo, vhi, wr):
        return _dx_fingerprint([reg, ts, vlo, vhi, wr], g3p)

    t_r1 = _dx_term(g2, fp(monty(r1_reg), monty(K * cyc), monty(rs1_lo),
                           monty(rs1_hi), zero_m),
                    F.add(active, monty(is_rf)))
    t_r2 = _dx_term(g2, fp(monty(r2_reg), monty(K * cyc + 1),
                           monty(_dx_bits(main, "rs2v", 0, 16)),
                           monty(_dx_bits(main, "rs2v", 16, 32)),
                           zero_m), active)
    t_w = _dx_term(g2, fp(monty(w_reg), monty(K * cyc + 2), monty(res_lo),
                          monty(res_hi), one_m), monty(w_act_all))
    t_a7 = _dx_term(g2, fp(monty(17 * is_sys), monty(K * cyc + 3),
                           monty(maddr_lo), monty(maddr_hi), zero_m),
                    selm("SYSTEM"))
    s_terms = []
    for u2 in range(N_REG_UNITS):
        s_terms.append(_dx_term(
            g2,
            fp(colm("m_reg", u2), colm("m_cyc", u2), colm("m_vlo", u2),
               colm("m_vhi", u2), colm("m_wr", u2)),
            colm("m_act", u2)))
    delta = F.ext_add(F.ext_add(t_r1, t_r2), F.ext_add(t_w, t_a7))
    for s_t in s_terms:
        delta = F.ext_sub(delta, s_t)
    racc = _dx_cumsum(delta)

    # --- data-memory argument (g4, g5) -----------------------------------
    g4, g5 = ch[4], ch[5]
    g5p = _dx_ext_powers(g5, 6)
    is_load = sel("LOAD")
    is_store = sel("STORE")
    is_meminit = sel("MEMINIT")
    is_memfin = sel("MEMFIN")
    smc = lambda k: col("sm_str", k)
    in_w, j_r, k_r, k_w = smc(0), smc(1), smc(2), smc(3)
    b_r, b_w, sh_r, sh_w = smc(4), smc(5), smc(6), smc(7)
    wa_m = monty(_dx_bits(main, "maddr", 2, 32))
    mword_lo = _dx_bits(main, "mword", 0, 16)
    mword_hi = _dx_bits(main, "mword", 16, 32)
    mwnew_lo = _dx_bits(main, "mwnew", 0, 16)
    mwnew_hi = _dx_bits(main, "mwnew", 16, 32)
    mword_lo_m, mword_hi_m = monty(mword_lo), monty(mword_hi)
    mwnew_lo_m, mwnew_hi_m = monty(mwnew_lo), monty(mwnew_hi)

    def fpm(wav, ts, vlo, vhi, wr, kind):
        return _dx_fingerprint([wav, ts, vlo, vhi, wr, kind], g5p)

    act_r = is_load + is_store + is_memfin + j_r + k_r + b_r + sh_r
    act_w = is_store + is_meminit + in_w + k_w + b_w + sh_w
    mu_r = _dx_term(g4, fpm(wa_m, monty(2 * cyc), mword_lo_m, mword_hi_m,
                            zero_m, monty(2 * is_memfin)), monty(act_r))
    mu_w = _dx_term(g4, fpm(wa_m, monty(2 * cyc + 1), mwnew_lo_m,
                            mwnew_hi_m, one_m, monty(is_meminit)),
                    monty(act_w))
    msort = []
    for u2 in range(N_MEM_UNITS):
        msort.append(_dx_term(
            g4,
            fpm(colm("ms_wa", u2), colm("ms_ts", u2), colm("ms_vlo", u2),
                colm("ms_vhi", u2), colm("ms_wr", u2), colm("ms_kind", u2)),
            colm("ms_act", u2)))
    mdelta = F.ext_sub(F.ext_sub(F.ext_add(mu_r, mu_w), msort[0]), msort[1])
    macc = _dx_cumsum(mdelta)

    # --- MEMINIT/MEMFIN list-binding sums --------------------------------
    fp2_i = _dx_fingerprint([wa_m, mwnew_lo_m, mwnew_hi_m], g5p)
    fp2_f = _dx_fingerprint([wa_m, mword_lo_m, mword_hi_m], g5p)
    li = _dx_term(g4, fp2_i, selm("MEMINIT"))
    lf = _dx_term(g4, fp2_f, selm("MEMFIN"))
    liacc = _dx_cumsum(li)
    lfacc = _dx_cumsum(lf)

    # --- RLC chains (g6): the four IO streams, then the entry and exit
    # registers; the six scans run as one, stacked on a middle axis ------
    g6 = ch[6]
    g6sq = F.ext_mul(g6, g6)
    acts = [j_r, k_r + k_w, b_r + b_w, sh_r + sh_w, is_init, is_rf]
    los = [mword_lo, k_r * mword_lo + k_w * mwnew_lo,
           b_r * mword_lo + b_w * mwnew_lo,
           sh_r * mword_lo + sh_w * mwnew_lo, res_lo, rs1_lo]
    his = [mword_hi, k_r * mword_hi + k_w * mwnew_hi,
           b_r * mword_hi + b_w * mwnew_hi,
           sh_r * mword_hi + sh_w * mwnew_hi, res_hi, rs1_hi]
    val = F.ext_add(F.ext_mul_base(g6, monty(torch.stack(los, dim=1))),
                    F.ext_from_base(monty(torch.stack(his, dim=1))))
    chains = _dx_rlc_chain(monty(torch.stack(acts, dim=1)), val, g6sq,
                           one_ext)                # (n, 6, 4)

    return torch.cat(
        [t, u, acc, t_r1, t_r2, t_w, t_a7,
         s_terms[0], s_terms[1], s_terms[2], s_terms[3], racc,
         mu_r, mu_w, msort[0], msort[1], macc,
         li, lf, liacc, lfacc, chains.reshape(n, 24)], dim=1)
