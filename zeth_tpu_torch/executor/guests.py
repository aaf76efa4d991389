"""Built-in guest programs (assembled RV32IM) for tests and benchmarks.

These play the role of the reference's guest binaries (SURVEY.md §2.1,
guests/stateless-client) at executor-bringup scale: each returns ELF
bytes for a self-contained program using the zkVM ABI.
"""

from __future__ import annotations

from .assembler import Asm
from .elf import write_elf

STACK_TOP = 0x0020_0000
SCRATCH = 0x0010_0000


def sum_loop(n: int) -> bytes:
    """Sum 1..n, commit the 4-byte result, halt(0)."""
    a = Asm(org=0x10000)
    a.li("t0", 0)          # acc
    a.li("t1", 1)          # i
    a.li("t2", n)
    a.label("loop")
    a.add("t0", "t0", "t1")
    a.addi("t1", "t1", 1)
    a.bge("t2", "t1", "loop")
    # store acc to scratch, commit 4 bytes
    a.li("t3", SCRATCH)
    a.sw("t0", "t3", 0)
    a.mv("a0", "t3")
    a.li("a1", 4)
    a.li("a7", 2)
    a.ecall()
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def echo_input(nbytes: int) -> bytes:
    """Read nbytes of input, commit them back, halt(0)."""
    a = Asm(org=0x10000)
    a.li("a0", SCRATCH)
    a.li("a1", nbytes)
    a.li("a7", 1)
    a.ecall()              # a0 = bytes read
    a.mv("t0", "a0")
    a.li("a0", SCRATCH)
    a.mv("a1", "t0")
    a.li("a7", 2)
    a.ecall()
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def muldiv_check() -> bytes:
    """Exercise M-extension edge cases; commit 9 result words."""
    a = Asm(org=0x10000)
    a.li("s0", SCRATCH)
    # mul 0x12345678 * 0x9abcdef0 (low & high, signed/unsigned)
    a.li("t0", 0x12345678)
    a.li("t1", 0x9ABCDEF0)
    a.mul("t2", "t0", "t1");    a.sw("t2", "s0", 0)
    a.mulh("t2", "t0", "t1");   a.sw("t2", "s0", 4)
    a.mulhu("t2", "t0", "t1");  a.sw("t2", "s0", 8)
    a.mulhsu("t2", "t0", "t1"); a.sw("t2", "s0", 12)
    # div/rem edge: INT_MIN / -1, div by zero
    a.li("t0", -0x80000000)
    a.li("t1", -1)
    a.div("t2", "t0", "t1");    a.sw("t2", "s0", 16)
    a.rem("t2", "t0", "t1");    a.sw("t2", "s0", 20)
    a.li("t1", 0)
    a.div("t2", "t0", "t1");    a.sw("t2", "s0", 24)
    a.divu("t2", "t0", "t1");   a.sw("t2", "s0", 28)
    a.remu("t2", "t0", "t1");   a.sw("t2", "s0", 32)
    # unsigned divide with a real divisor
    a.li("t0", 0xDEADBEEF)
    a.li("t1", 0x1234)
    a.divu("t2", "t0", "t1");   a.sw("t2", "s0", 36)
    a.remu("t2", "t0", "t1");   a.sw("t2", "s0", 40)
    a.mv("a0", "s0")
    a.li("a1", 44)
    a.li("a7", 2)
    a.ecall()
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def keccak_guest(rounds: int) -> bytes:
    """Apply keccak-f to a zero state `rounds` times; commit first 8 bytes."""
    a = Asm(org=0x10000)
    a.li("s0", SCRATCH)        # 200-byte state (zero pages)
    a.li("s1", rounds)
    a.label("loop")
    a.mv("a0", "s0")
    a.li("a7", 5)
    a.ecall()
    a.addi("s1", "s1", -1)
    a.bne("s1", "zero", "loop")
    a.mv("a0", "s0")
    a.li("a1", 8)
    a.li("a7", 2)
    a.ecall()
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def bigint_guest(a: int, b: int, m: int, reps: int = 1) -> bytes:
    """Compute r = a*b mod m via the bigint accelerator syscall `reps`
    times (chained: a <- r), then commit the 48-byte result. Operands
    occupy 48-byte slots (the accelerator is 384-bit wide)."""
    g = Asm(org=0x10000)
    g.li("s0", SCRATCH)        # [a | b | m | r] 4 x 48 bytes
    for off, val in ((0, a), (48, b), (96, m)):
        for w in range(12):
            g.li("t0", (val >> (32 * w)) & 0xFFFFFFFF)
            g.sw("t0", "s0", off + 4 * w)
    g.li("s1", reps)
    g.label("loop")
    g.mv("a0", "s0")
    g.li("a7", 6)
    g.ecall()
    # chain: copy r into a for the next round
    for w in range(12):
        g.lw("t0", "s0", 144 + 4 * w)
        g.sw("t0", "s0", 4 * w)
    g.addi("s1", "s1", -1)
    g.bne("s1", "zero", "loop")
    g.li("a0", SCRATCH + 144)
    g.li("a1", 48)
    g.li("a7", 2)
    g.ecall()
    g.li("a0", 0)
    g.sys_halt()
    return write_elf([(g.org, g.assemble())], g.org)


def sha256_guest(state: list, block: list, reps: int = 1) -> bytes:
    """Chain `reps` SHA-256 compressions via the accelerator syscall
    (state <- compress(state, block)), then commit the 32-byte state."""
    g = Asm(org=0x10000)
    g.li("s0", SCRATCH)        # [state 8w | block 16w | out 8w]
    for i, w in enumerate(list(state) + list(block)):
        g.li("t0", int(w) & 0xFFFFFFFF)
        g.sw("t0", "s0", 4 * i)
    g.li("s1", reps)
    g.label("loop")
    g.mv("a0", "s0")
    g.li("a7", 7)
    g.ecall()
    for w in range(8):
        g.lw("t0", "s0", 96 + 4 * w)
        g.sw("t0", "s0", 4 * w)
    g.addi("s1", "s1", -1)
    g.bne("s1", "zero", "loop")
    g.li("a0", SCRATCH + 96)
    g.li("a1", 32)
    g.li("a7", 2)
    g.ecall()
    g.li("a0", 0)
    g.sys_halt()
    return write_elf([(g.org, g.assemble())], g.org)


def load_store(n: int = 8) -> bytes:
    """Exercise every load/store width: write a pattern with SB/SH/SW,
    read it back with LB/LH/LW/LBU/LHU, xor-fold, commit 4 bytes."""
    a = Asm(org=0x10000)
    a.li("s0", SCRATCH)
    a.li("t0", 0)                # i
    a.li("t1", n)
    a.li("s1", 0)                # acc
    a.label("wloop")
    # value = 0xA5000000 | (i * 0x010101)
    a.li("t2", 0x010101)
    a.mul("t3", "t0", "t2")
    a.li("t2", 0xA5000000)
    a.or_("t3", "t3", "t2")
    a.slli("t4", "t0", 2)
    a.add("t4", "t4", "s0")
    a.sw("t3", "t4", 0)
    a.addi("t0", "t0", 1)
    a.blt("t0", "t1", "wloop")
    # sub-word stores into the tail word
    a.slli("t4", "t1", 2)
    a.add("t4", "t4", "s0")
    a.li("t3", 0x7F)
    a.sb("t3", "t4", 0)
    a.sb("t3", "t4", 3)
    a.li("t3", 0xBEEF)
    a.sh("t3", "t4", 0)          # overwrites bytes 0-1
    # read everything back through every width
    a.li("t0", 0)
    a.label("rloop")
    a.slli("t4", "t0", 2)
    a.add("t4", "t4", "s0")
    a.lw("t3", "t4", 0)
    a.xor("s1", "s1", "t3")
    a.lb("t3", "t4", 1)
    a.add("s1", "s1", "t3")
    a.lbu("t3", "t4", 2)
    a.xor("s1", "s1", "t3")
    a.lh("t3", "t4", 0)
    a.add("s1", "s1", "t3")
    a.lhu("t3", "t4", 2)
    a.xor("s1", "s1", "t3")
    a.addi("t0", "t0", 1)
    a.blt("t0", "t1", "rloop")
    a.sw("s1", "s0", 0)
    a.mv("a0", "s0")
    a.li("a1", 4)
    a.li("a7", 2)
    a.ecall()
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def memory_stress(pages: int) -> bytes:
    """Write one word into each of `pages` fresh pages, then halt."""
    a = Asm(org=0x10000)
    a.li("t0", SCRATCH)
    a.li("t1", pages)
    a.li("t2", 0)
    a.label("loop")
    a.sw("t2", "t0", 0)
    a.li("t3", 4096)
    a.add("t0", "t0", "t3")
    a.addi("t2", "t2", 1)
    a.blt("t2", "t1", "loop")
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)


def spin(cycles: int) -> bytes:
    """Busy-loop approximately `cycles` user cycles (for segmentation tests)."""
    a = Asm(org=0x10000)
    iters = max(cycles // 3, 1)
    a.li("t0", iters)
    a.label("loop")
    a.addi("t0", "t0", -1)
    a.bne("t0", "zero", "loop")
    a.li("a0", 0)
    a.sys_halt()
    return write_elf([(a.org, a.assemble())], a.org)
