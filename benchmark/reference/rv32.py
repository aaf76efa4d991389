"""The first segment of a guest's execution, worked out step by step.

A plain RV32IM interpreter of the zkVM's guest ABI, written from the
RISC-V unprivileged specification (RV32I and the M extension) and the
ABI's published rules: ``ecall`` with the call number in a7 (0 halt with
exit code a0, 1 read a1 bytes of input into a0 and return the count, 2
commit a1 bytes at a0 to the journal, 3 log, 4 read the cycle count, 5
keccak-f[1600] over the 50 words at a0 in place, 6 a*b mod m over the
four 12-word numbers at a0 with the result written last, 7 the SHA-256
compression of the 8 state and 16 block words at a0 into the 8 words
after them); buffers and lengths of the IO calls are word-aligned.

A segment's cycles are one a retired instruction, one a word of call IO
(read, journal and accelerator words), and 864 (one paging slot) for
each 1 KiB page the segment touches, fetches included. The segment ends
before the instruction at which cycles + 2*864 + 128 would reach
2**po2, or after the halting call. The result is what the segment proof
must claim: the exit pc and registers, halt and exit code, the journal
and the memory it wrote.
"""

from __future__ import annotations

import numpy as np

from . import keccakf, sha256

M32 = 0xFFFFFFFF
PAGE_CYCLES = 864
PAGE_BITS = 10


class GuestFault(Exception):
    """The guest did what the ABI forbids: the segment has no claim."""


def _signed(v: int) -> int:
    return v - (1 << 32) if v & 0x80000000 else v


def _div(a: int, b: int) -> int:
    """RISC-V DIV on signed values: rounds toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def run_segment(entry: int, addrs, words, input_bytes: bytes,
                po2: int) -> dict:
    """Execute the image (`addrs`, `words`, entry pc `entry`) on the input
    `input_bytes` through its first segment of 2**`po2` cycles."""
    mem = {int(a): int(w) for a, w in zip(addrs, words)}
    inp = bytes(input_bytes) + b"\x00" * (-len(input_bytes) % 4)
    pos = 0
    regs = [0] * 32
    pc = int(entry)
    pages = set()
    written = {}
    journal = bytearray()
    cycles = 0
    halted = False
    exit_code = 0
    limit = (1 << po2) - 2 * PAGE_CYCLES - 128

    def load(a):
        pages.add(a >> PAGE_BITS)
        return mem.get(a, 0)

    def store(a, v):
        pages.add(a >> PAGE_BITS)
        mem[a] = v
        written[a] = v

    while cycles + PAGE_CYCLES * len(pages) < limit:
        insn = load(pc)
        op = insn & 0x7F
        rd = (insn >> 7) & 31
        f3 = (insn >> 12) & 7
        v1 = regs[(insn >> 15) & 31]
        rs2 = (insn >> 20) & 31
        v2 = regs[rs2]
        f7 = insn >> 25
        nxt = (pc + 4) & M32
        out = None
        if op == 0x13:                                     # op-imm
            imm = _signed(insn) >> 20
            if f3 == 0:
                out = v1 + imm
            elif f3 == 1:
                out = v1 << rs2
            elif f3 == 2:
                out = int(_signed(v1) < imm)
            elif f3 == 3:
                out = int(v1 < (imm & M32))
            elif f3 == 4:
                out = v1 ^ imm
            elif f3 == 5:
                out = _signed(v1) >> rs2 if f7 & 0x20 else v1 >> rs2
            elif f3 == 6:
                out = v1 | imm
            else:
                out = v1 & imm
        elif op == 0x33:                                   # op
            if f7 == 1:
                s1, s2 = _signed(v1), _signed(v2)
                if f3 == 0:
                    out = v1 * v2
                elif f3 == 1:
                    out = (s1 * s2) >> 32
                elif f3 == 2:
                    out = (s1 * v2) >> 32
                elif f3 == 3:
                    out = (v1 * v2) >> 32
                elif f3 == 4:
                    out = M32 if s2 == 0 else (
                        s1 if s1 == -2**31 and s2 == -1 else _div(s1, s2))
                elif f3 == 5:
                    out = M32 if v2 == 0 else v1 // v2
                elif f3 == 6:
                    out = s1 if s2 == 0 else (
                        0 if s1 == -2**31 and s2 == -1
                        else s1 - s2 * _div(s1, s2))
                else:
                    out = v1 if v2 == 0 else v1 % v2
            else:
                sh = v2 & 31
                if f3 == 0:
                    out = v1 - v2 if f7 & 0x20 else v1 + v2
                elif f3 == 1:
                    out = v1 << sh
                elif f3 == 2:
                    out = int(_signed(v1) < _signed(v2))
                elif f3 == 3:
                    out = int(v1 < v2)
                elif f3 == 4:
                    out = v1 ^ v2
                elif f3 == 5:
                    out = _signed(v1) >> sh if f7 & 0x20 else v1 >> sh
                elif f3 == 6:
                    out = v1 | v2
                else:
                    out = v1 & v2
        elif op == 0x03:                                   # loads
            a = (v1 + (_signed(insn) >> 20)) & M32
            if (f3 in (1, 5) and a & 1) or (f3 == 2 and a & 3) \
                    or f3 not in (0, 1, 2, 4, 5):
                raise GuestFault(f"load at pc 0x{pc:08x}")
            w = load(a & ~3)
            if f3 == 2:
                out = w
            elif f3 in (0, 4):
                b = (w >> (8 * (a & 3))) & 0xFF
                out = b - 0x100 if f3 == 0 and b & 0x80 else b
            else:
                h = (w >> (8 * (a & 2))) & 0xFFFF
                out = h - 0x10000 if f3 == 1 and h & 0x8000 else h
        elif op == 0x23:                                   # stores
            imm = ((_signed(insn) >> 20) & ~0x1F) | ((insn >> 7) & 0x1F)
            a = (v1 + imm) & M32
            if (f3 == 1 and a & 1) or (f3 == 2 and a & 3) or f3 > 2:
                raise GuestFault(f"store at pc 0x{pc:08x}")
            w = load(a & ~3)
            if f3 == 2:
                store(a, v2)
            else:
                sh = 8 * (a & (3 if f3 == 0 else 2))
                m = (0xFF if f3 == 0 else 0xFFFF) << sh
                store(a & ~3, (w & ~m & M32) | ((v2 << sh) & m))
        elif op == 0x63:                                   # branches
            imm = ((_signed(insn) >> 19) & ~0xFFF) | ((insn << 4) & 0x800) \
                | ((insn >> 20) & 0x7E0) | ((insn >> 7) & 0x1E)
            if f3 == 0:
                take = v1 == v2
            elif f3 == 1:
                take = v1 != v2
            elif f3 == 4:
                take = _signed(v1) < _signed(v2)
            elif f3 == 5:
                take = _signed(v1) >= _signed(v2)
            elif f3 == 6:
                take = v1 < v2
            elif f3 == 7:
                take = v1 >= v2
            else:
                raise GuestFault(f"branch at pc 0x{pc:08x}")
            if take:
                nxt = (pc + imm) & M32
        elif op == 0x37:                                   # LUI
            out = insn & 0xFFFFF000
        elif op == 0x17:                                   # AUIPC
            out = pc + (insn & 0xFFFFF000)
        elif op == 0x6F:                                   # JAL
            imm = ((_signed(insn) >> 11) & ~0xFFFFF) | (insn & 0xFF000) \
                | ((insn >> 9) & 0x800) | ((insn >> 20) & 0x7FE)
            out, nxt = pc + 4, (pc + imm) & M32
        elif op == 0x67:                                   # JALR
            out, nxt = pc + 4, (v1 + (_signed(insn) >> 20)) & M32 & ~1
        elif op == 0x0F:                                   # FENCE
            pass
        elif insn == 0x73:                                 # ECALL
            call, a0, a1 = regs[17], regs[10], regs[11]
            io = 0
            if call == 0:
                halted, exit_code = True, a0
            elif call == 1:
                n = min(a1, len(inp) - pos)
                if a0 & 3 or a1 & 3 or n & 3:
                    raise GuestFault("unaligned read")
                for off in range(0, n, 4):
                    load(a0 + off)
                    store(a0 + off, int.from_bytes(
                        inp[pos + off:pos + off + 4], "little"))
                pos += n
                regs[10] = n
                io = n // 4
            elif call == 2:
                if a0 & 3 or a1 & 3:
                    raise GuestFault("unaligned commit")
                for off in range(0, a1, 4):
                    journal += load(a0 + off).to_bytes(4, "little")
                io = a1 // 4
            elif call == 3:
                for i in range(a1):
                    load((a0 + i) & ~3)
            elif call == 4:
                regs[10] = cycles & M32
            elif call in (5, 6, 7):
                if a0 & 3:
                    raise GuestFault("unaligned accelerator call")
                n_in, n_out = {5: (50, 50), 6: (36, 12), 7: (24, 8)}[call]
                ws = [load(a0 + 4 * i) for i in range(n_in)]
                if call == 5:
                    lanes = np.array([[ws[2 * i] | (ws[2 * i + 1] << 32)
                                       for i in range(25)]], np.uint64)
                    res = [int(x) for lane in keccakf.permute(lanes)[0]
                           for x in (int(lane) & M32, int(lane) >> 32)]
                    at = a0
                elif call == 6:
                    a, b, m = (sum(ws[12 * j + k] << (32 * k)
                                   for k in range(12)) for j in range(3))
                    if m == 0:
                        raise GuestFault("bigint modulus 0")
                    r = a * b % m
                    res = [(r >> (32 * k)) & M32 for k in range(12)]
                    at = a0 + 144
                else:
                    res = sha256.compress(ws[:8], ws[8:24])
                    at = a0 + 96
                for i, v in enumerate(res):
                    load(at + 4 * i)
                    store(at + 4 * i, v)
                io = n_in + n_out
            else:
                raise GuestFault(f"unknown call {call}")
            cycles += io
        else:
            raise GuestFault(f"instruction 0x{insn:08x} at pc 0x{pc:08x}")
        if out is not None and rd:
            regs[rd] = out & M32
        pc = nxt
        cycles += 1
        if halted:
            break
    return {"exit_pc": pc, "exit_regs": regs, "halted": halted,
            "exit_code": exit_code, "journal": bytes(journal),
            "written": written, "user_cycles": cycles}
