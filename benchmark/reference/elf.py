"""The initial memory image of a 32-bit little-endian RISC-V ELF.

Each PT_LOAD segment's file bytes are stored at its virtual address; the
rest of memory is zero. The image is every nonzero word, sorted by
address: the (entry pc, addresses, words) that the rv32im AIR's program
ROM and the page tree are built from.
"""

from __future__ import annotations

import struct

import numpy as np


def load_image(elf: bytes) -> tuple[int, np.ndarray, np.ndarray]:
    """(entry pc, sorted word addresses, words) as uint64 arrays."""
    if elf[:4] != b"\x7fELF" or elf[4] != 1 or elf[5] != 1:
        raise ValueError("not a 32-bit little-endian ELF")
    if struct.unpack_from("<H", elf, 18)[0] != 0xF3:
        raise ValueError("not a RISC-V ELF")
    entry, phoff = struct.unpack_from("<II", elf, 24)
    phentsize, phnum = struct.unpack_from("<HH", elf, 42)
    mem: dict[int, int] = {}
    for i in range(phnum):
        (ptype, off, vaddr, _paddr, filesz, _memsz, _flags,
         _align) = struct.unpack_from("<8I", elf, phoff + i * phentsize)
        if ptype != 1:
            continue
        if off + filesz > len(elf):
            raise ValueError("PT_LOAD segment past the end of the file")
        for j, byte in enumerate(elf[off:off + filesz]):
            mem[vaddr + j] = byte
    words: dict[int, int] = {}
    for addr, byte in mem.items():
        w = addr & ~3
        words[w] = words.get(w, 0) | (byte << (8 * (addr & 3)))
    addrs = np.array(sorted(a for a, v in words.items() if v), np.uint64)
    vals = np.array([words[int(a)] for a in addrs], np.uint64)
    return entry, addrs, vals
