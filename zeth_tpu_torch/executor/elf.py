"""Minimal ELF32 RISC-V writer (and header reader) for guest images.

Replaces the guest-build packaging role of risc0-binfmt / risc0-build
(SURVEY.md §2.2): guests assembled with ``assembler.Asm`` are serialized
to standard ELF32 little-endian RV32 executables that the C++ executor
(and any stock RISC-V tooling) can load.
"""

from __future__ import annotations

import struct

EM_RISCV = 0xF3
PT_LOAD = 1


def write_elf(segments: list[tuple[int, bytes]], entry: int) -> bytes:
    """segments: [(vaddr, data)] -> ELF32 bytes."""
    ehsize = 52
    phentsize = 32
    phoff = ehsize
    n = len(segments)
    data_off = phoff + phentsize * n
    # pad each segment start to 4 bytes
    blobs = []
    offs = []
    cur = data_off
    for _, data in segments:
        pad = -cur % 4
        cur += pad
        offs.append(cur)
        blobs.append(b"\x00" * pad + data)
        cur += len(data)

    ident = b"\x7fELF" + bytes([1, 1, 1, 0]) + b"\x00" * 8
    ehdr = struct.pack(
        "<16sHHIIIIIHHHHHH", ident,
        2,              # ET_EXEC
        EM_RISCV,
        1,              # version
        entry,
        phoff, 0, 0,    # phoff, shoff, flags
        ehsize, phentsize, n, 0, 0, 0)
    phdrs = b""
    for (vaddr, data), off in zip(segments, offs):
        phdrs += struct.pack(
            "<IIIIIIII", PT_LOAD, off, vaddr, vaddr,
            len(data), len(data), 7, 4)   # RWX, align 4
    return ehdr + phdrs + b"".join(blobs)


def read_entry(elf: bytes) -> int:
    return struct.unpack_from("<I", elf, 24)[0]
