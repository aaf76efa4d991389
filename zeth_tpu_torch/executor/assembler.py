"""Tiny RV32IM assembler (labels + full base ISA + M extension).

Copy of ``zeth_tpu.executor.assembler``. Guest programs for tests and
benchmarks are authored directly in Python (no RISC-V cross-toolchain is
needed) and serialized with ``zeth_tpu_torch.executor.elf.write_elf``.
"""

from __future__ import annotations

import struct

REGS = {f"x{i}": i for i in range(32)}
REGS.update({
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4,
    "t0": 5, "t1": 6, "t2": 7, "s0": 8, "fp": 8, "s1": 9,
    "a0": 10, "a1": 11, "a2": 12, "a3": 13, "a4": 14, "a5": 15,
    "a6": 16, "a7": 17,
    "s2": 18, "s3": 19, "s4": 20, "s5": 21, "s6": 22, "s7": 23,
    "s8": 24, "s9": 25, "s10": 26, "s11": 27,
    "t3": 28, "t4": 29, "t5": 30, "t6": 31,
})


def _r(x):
    return REGS[x] if isinstance(x, str) else int(x)


def _enc_r(op, rd, f3, rs1, rs2, f7):
    return op | (_r(rd) << 7) | (f3 << 12) | (_r(rs1) << 15) | (_r(rs2) << 20) | (f7 << 25)


def _enc_i(op, rd, f3, rs1, imm):
    imm &= 0xFFF
    return op | (_r(rd) << 7) | (f3 << 12) | (_r(rs1) << 15) | (imm << 20)


def _enc_s(op, f3, rs1, rs2, imm):
    imm &= 0xFFF
    return (op | ((imm & 0x1F) << 7) | (f3 << 12) | (_r(rs1) << 15)
            | (_r(rs2) << 20) | ((imm >> 5) << 25))


def _enc_b(op, f3, rs1, rs2, imm):
    imm &= 0x1FFF
    return (op | (((imm >> 11) & 1) << 7) | (((imm >> 1) & 0xF) << 8)
            | (f3 << 12) | (_r(rs1) << 15) | (_r(rs2) << 20)
            | (((imm >> 5) & 0x3F) << 25) | (((imm >> 12) & 1) << 31))


def _enc_u(op, rd, imm):
    return op | (_r(rd) << 7) | (imm & 0xFFFFF000)


def _enc_j(op, rd, imm):
    imm &= 0x1FFFFF
    return (op | (_r(rd) << 7) | (imm & 0xFF000)
            | (((imm >> 11) & 1) << 20) | (((imm >> 1) & 0x3FF) << 21)
            | (((imm >> 20) & 1) << 31))


class Asm:
    def __init__(self, org: int = 0x10000):
        self.org = org
        self.items: list = []      # ints (encoded) or ("fix", fn, label)
        self.labels: dict[str, int] = {}

    # -- layout ------------------------------------------------------------

    def label(self, name: str):
        self.labels[name] = self.org + 4 * len(self.items)
        return self

    def pc(self) -> int:
        return self.org + 4 * len(self.items)

    def word(self, v: int):
        self.items.append(v & 0xFFFFFFFF)
        return self

    def _emit(self, w):
        self.items.append(w)
        return self

    def _emit_fix(self, fn, label):
        self.items.append(("fix", fn, label, self.pc()))
        return self

    # -- instructions ------------------------------------------------------

    def lui(self, rd, imm):   return self._emit(_enc_u(0x37, rd, imm << 12))
    def auipc(self, rd, imm): return self._emit(_enc_u(0x17, rd, imm << 12))

    def addi(self, rd, rs1, imm):  return self._emit(_enc_i(0x13, rd, 0, rs1, imm))
    def slti(self, rd, rs1, imm):  return self._emit(_enc_i(0x13, rd, 2, rs1, imm))
    def sltiu(self, rd, rs1, imm): return self._emit(_enc_i(0x13, rd, 3, rs1, imm))
    def xori(self, rd, rs1, imm):  return self._emit(_enc_i(0x13, rd, 4, rs1, imm))
    def ori(self, rd, rs1, imm):   return self._emit(_enc_i(0x13, rd, 6, rs1, imm))
    def andi(self, rd, rs1, imm):  return self._emit(_enc_i(0x13, rd, 7, rs1, imm))
    def slli(self, rd, rs1, sh):   return self._emit(_enc_i(0x13, rd, 1, rs1, sh))
    def srli(self, rd, rs1, sh):   return self._emit(_enc_i(0x13, rd, 5, rs1, sh))
    def srai(self, rd, rs1, sh):   return self._emit(_enc_i(0x13, rd, 5, rs1, sh | 0x400))

    def add(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 0, a, b, 0))
    def sub(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 0, a, b, 0x20))
    def sll(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 1, a, b, 0))
    def slt(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 2, a, b, 0))
    def sltu(self, rd, a, b): return self._emit(_enc_r(0x33, rd, 3, a, b, 0))
    def xor(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 4, a, b, 0))
    def srl(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 5, a, b, 0))
    def sra(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 5, a, b, 0x20))
    def or_(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 6, a, b, 0))
    def and_(self, rd, a, b): return self._emit(_enc_r(0x33, rd, 7, a, b, 0))

    def mul(self, rd, a, b):    return self._emit(_enc_r(0x33, rd, 0, a, b, 1))
    def mulh(self, rd, a, b):   return self._emit(_enc_r(0x33, rd, 1, a, b, 1))
    def mulhsu(self, rd, a, b): return self._emit(_enc_r(0x33, rd, 2, a, b, 1))
    def mulhu(self, rd, a, b):  return self._emit(_enc_r(0x33, rd, 3, a, b, 1))
    def div(self, rd, a, b):    return self._emit(_enc_r(0x33, rd, 4, a, b, 1))
    def divu(self, rd, a, b):   return self._emit(_enc_r(0x33, rd, 5, a, b, 1))
    def rem(self, rd, a, b):    return self._emit(_enc_r(0x33, rd, 6, a, b, 1))
    def remu(self, rd, a, b):   return self._emit(_enc_r(0x33, rd, 7, a, b, 1))

    def lb(self, rd, rs1, imm):  return self._emit(_enc_i(0x03, rd, 0, rs1, imm))
    def lh(self, rd, rs1, imm):  return self._emit(_enc_i(0x03, rd, 1, rs1, imm))
    def lw(self, rd, rs1, imm):  return self._emit(_enc_i(0x03, rd, 2, rs1, imm))
    def lbu(self, rd, rs1, imm): return self._emit(_enc_i(0x03, rd, 4, rs1, imm))
    def lhu(self, rd, rs1, imm): return self._emit(_enc_i(0x03, rd, 5, rs1, imm))

    def sb(self, rs2, rs1, imm): return self._emit(_enc_s(0x23, 0, rs1, rs2, imm))
    def sh(self, rs2, rs1, imm): return self._emit(_enc_s(0x23, 1, rs1, rs2, imm))
    def sw(self, rs2, rs1, imm): return self._emit(_enc_s(0x23, 2, rs1, rs2, imm))

    def _branch(self, f3, a, b, label):
        return self._emit_fix(
            lambda pc, tgt, f3=f3, a=a, b=b: _enc_b(0x63, f3, a, b, tgt - pc), label)

    def beq(self, a, b, label):  return self._branch(0, a, b, label)
    def bne(self, a, b, label):  return self._branch(1, a, b, label)
    def blt(self, a, b, label):  return self._branch(4, a, b, label)
    def bge(self, a, b, label):  return self._branch(5, a, b, label)
    def bltu(self, a, b, label): return self._branch(6, a, b, label)
    def bgeu(self, a, b, label): return self._branch(7, a, b, label)

    def jal(self, rd, label):
        return self._emit_fix(
            lambda pc, tgt, rd=rd: _enc_j(0x6F, rd, tgt - pc), label)

    def jalr(self, rd, rs1, imm=0):
        return self._emit(_enc_i(0x67, rd, 0, rs1, imm))

    def j(self, label):   return self.jal("zero", label)
    def ret(self):        return self.jalr("zero", "ra", 0)
    def ecall(self):      return self._emit(0x00000073)
    def nop(self):        return self.addi("zero", "zero", 0)
    def mv(self, rd, rs): return self.addi(rd, rs, 0)

    def li(self, rd, imm):
        """Load 32-bit immediate (lui+addi as needed)."""
        imm &= 0xFFFFFFFF
        lo = imm & 0xFFF
        if lo >= 0x800:
            lo -= 0x1000
        hi = (imm - lo) & 0xFFFFFFFF
        if hi:
            self.lui(rd, (hi >> 12) & 0xFFFFF)
            if lo:
                self.addi(rd, rd, lo)
        else:
            self.addi(rd, "zero", lo)
        return self

    # -- syscall macros (ABI in executor/__init__.py) ----------------------

    def sys_halt(self, code_reg="a0"):
        if code_reg != "a0":
            self.mv("a0", code_reg)
        self.li("a7", 0)
        return self.ecall()

    def sys_read(self, dst_reg, len_reg):
        self.mv("a0", dst_reg) if dst_reg != "a0" else None
        self.mv("a1", len_reg) if len_reg != "a1" else None
        self.li("a7", 1)
        return self.ecall()

    def sys_commit(self, src_reg="a0", len_reg="a1"):
        self.li("a7", 2)
        return self.ecall()

    def sys_log(self):
        self.li("a7", 3)
        return self.ecall()

    def sys_keccak(self):
        self.li("a7", 5)
        return self.ecall()

    # -- finalize ----------------------------------------------------------

    def assemble(self) -> bytes:
        out = []
        for i, item in enumerate(self.items):
            if isinstance(item, tuple):
                _, fn, label, pc = item
                tgt = self.labels[label]
                out.append(fn(pc, tgt) & 0xFFFFFFFF)
            else:
                out.append(item)
        return struct.pack(f"<{len(out)}I", *out)
