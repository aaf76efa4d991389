"""RV32IM zkVM executor: C++ emulator core + Python orchestration.

Copy of ``zeth_tpu.executor`` (the same ``rv32im.cpp``), so that the port
imports nothing of the JAX package; tests/test_torch_executor.py holds the
two equal. ``pack_rows`` (``csrc/pack.cpp``, the same file) packs the
main trace for the prover's bit-packed upload.

Replacement for risc0-circuit-rv32im's executor/emulator
(SURVEY.md §2.2): the hot interpreter loop, paged memory, segmentation
and cycle accounting run in native C++ (ctypes, built by csrc/Makefile
with the host ``g++`` at first use); Python owns ELF/guest tooling.

zkVM ABI (this framework's own; mirrors the reference's surface —
`env::read/commit_slice/log`, cycle tracking, keccak acceleration,
guests/stateless-client/src/lib.rs:17-33):

  ecall with a7 = syscall number:
    0 HALT    a0 = exit code
    1 READ    a0 = dst ptr, a1 = max bytes   -> a0 = bytes read (from input)
    2 COMMIT  a0 = src ptr, a1 = bytes          (append to journal)
    3 LOG     a0 = src ptr, a1 = bytes          (host stderr/log buffer)
    4 CYCLE                                  -> a0 = user cycle count (lo32)
    5 KECCAK  a0 = ptr to 200-byte state        (host keccak-f[1600],
                                                 counted as accelerator call)
    6 BIGINT  a0 = ptr to 4x48-byte [a|b|m|r]   (host writes r = a*b mod m,
                                                 counted as accelerator call)
    7 SHA256  a0 = ptr to [state 8w|block 16w|out 8w]  (host writes the
                                                 compression feed-forward)

Cycle accounting (reference categories, run-parallel.sh:67-70):
  user cycles   = executed instructions
  paging cycles = PAGE_CYCLES per first touch (one paging-circuit slot
                  proves the page's pre and post hashes), charged per
                  segment
  total cycles  = user + paging, padded up to the segment power of two.

Memory: 4 KiB pages over a 32-bit space; the image ID is the Poseidon2
Merkle root of the initial memory image combined with the entry pc
(risc0-binfmt's image ID role, SURVEY.md §2.2).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass, field

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "csrc", "librv32im.so")

PAGE_SIZE = 1024
PAGE_CYCLES = 864    # paging-circuit rows per touched page (one slot)

# status codes returned by ex_run (keep in sync with rv32im.cpp)
ST_RUNNING = 0
ST_HALTED = 1
ST_SEGMENT_FULL = 2
ST_ERROR = 3


def _build():
    subprocess.run(["make", "-s", "-C", os.path.join(_DIR, "csrc"),
                    "librv32im.so"], check=True)


def _stale(so, srcs):
    if not os.path.exists(so):
        return True
    t = os.path.getmtime(so)
    return any(os.path.getmtime(s) > t for s in srcs if os.path.exists(s))


def _lib():
    if _stale(_SO, [os.path.join(_DIR, "csrc", "rv32im.cpp")]):
        _build()
    lib = ctypes.CDLL(_SO)
    lib.ex_create.restype = ctypes.c_void_p
    lib.ex_destroy.argtypes = [ctypes.c_void_p]
    lib.ex_load_elf.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.ex_set_input.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
    lib.ex_run.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.ex_user_cycles.restype = ctypes.c_uint64
    lib.ex_user_cycles.argtypes = [ctypes.c_void_p]
    lib.ex_paging_cycles.restype = ctypes.c_uint64
    lib.ex_paging_cycles.argtypes = [ctypes.c_void_p]
    lib.ex_segment_cycles.restype = ctypes.c_uint64
    lib.ex_segment_cycles.argtypes = [ctypes.c_void_p]
    lib.ex_exit_code.restype = ctypes.c_uint32
    lib.ex_exit_code.argtypes = [ctypes.c_void_p]
    lib.ex_regs.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32)]
    lib.ex_pc.restype = ctypes.c_uint32
    lib.ex_pc.argtypes = [ctypes.c_void_p]
    lib.ex_journal_len.restype = ctypes.c_size_t
    lib.ex_journal_len.argtypes = [ctypes.c_void_p]
    lib.ex_journal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ex_log_len.restype = ctypes.c_size_t
    lib.ex_log_len.argtypes = [ctypes.c_void_p]
    lib.ex_log.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ex_keccak_count.restype = ctypes.c_uint64
    lib.ex_keccak_count.argtypes = [ctypes.c_void_p]
    lib.ex_new_segment.argtypes = [ctypes.c_void_p]
    lib.ex_image_words.restype = ctypes.c_size_t
    lib.ex_image_words.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32), ctypes.c_size_t]
    lib.ex_keccak_inputs_len.restype = ctypes.c_size_t
    lib.ex_keccak_inputs_len.argtypes = [ctypes.c_void_p]
    lib.ex_keccak_inputs.restype = ctypes.POINTER(ctypes.c_uint64)
    lib.ex_keccak_inputs.argtypes = [ctypes.c_void_p]
    lib.ex_bigint_count.restype = ctypes.c_uint64
    lib.ex_bigint_count.argtypes = [ctypes.c_void_p]
    lib.ex_bigint_inputs_len.restype = ctypes.c_size_t
    lib.ex_bigint_inputs_len.argtypes = [ctypes.c_void_p]
    lib.ex_bigint_inputs.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.ex_bigint_inputs.argtypes = [ctypes.c_void_p]
    lib.ex_sha_count.restype = ctypes.c_uint64
    lib.ex_sha_count.argtypes = [ctypes.c_void_p]
    lib.ex_sha_inputs_len.restype = ctypes.c_size_t
    lib.ex_sha_inputs_len.argtypes = [ctypes.c_void_p]
    lib.ex_sha_inputs.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.ex_sha_inputs.argtypes = [ctypes.c_void_p]
    lib.ex_trace_enable.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ex_trace_len.restype = ctypes.c_size_t
    lib.ex_trace_len.argtypes = [ctypes.c_void_p]
    lib.ex_trace_data.restype = ctypes.POINTER(ctypes.c_uint32)
    lib.ex_trace_data.argtypes = [ctypes.c_void_p]
    lib.ex_segment_mem.restype = ctypes.c_size_t
    lib.ex_segment_mem.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.c_size_t]
    return lib


_LIB = None


def get_lib():
    global _LIB
    if _LIB is None:
        _LIB = _lib()
    return _LIB


_PACK_SO = os.path.join(_DIR, "csrc", "libpack.so")
_PACK_LIB = None


def _pack_lib():
    """libpack.so, built by make from csrc/pack.cpp at first use (and again
    when pack.cpp is newer); a failed build raises with make's output."""
    global _PACK_LIB
    if _PACK_LIB is None:
        if _stale(_PACK_SO, [os.path.join(_DIR, "csrc", "pack.cpp")]):
            proc = subprocess.run(
                ["make", "-s", "-C", os.path.join(_DIR, "csrc"), "libpack.so"],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {_PACK_SO} failed (make exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        lib = ctypes.CDLL(_PACK_SO)
        lib.zeth_pack_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        _PACK_LIB = lib
    return _PACK_LIB


def pack_rows(m: np.ndarray, bit_cols: np.ndarray, val_cols: np.ndarray,
              packed: np.ndarray, vals: np.ndarray,
              r0: int, r1: int) -> None:
    """Pack witness rows [r0, r1): bit columns -> u32 bit words, value
    columns -> u32. All arrays C-contiguous; m uint64 (n, C), packed
    uint32 (n, n_words), vals uint32 (n, n_vals). Releases the GIL, so
    callers thread over row ranges."""
    assert m.dtype == np.uint64 and m.flags.c_contiguous
    assert packed.dtype == np.uint32 and packed.flags.c_contiguous
    assert vals.dtype == np.uint32 and vals.flags.c_contiguous
    bit_cols = np.ascontiguousarray(bit_cols, np.int32)
    val_cols = np.ascontiguousarray(val_cols, np.int32)
    assert packed.shape[1] * 32 >= len(bit_cols)
    # the C kernel uses len(val_cols) as the vals row stride
    assert len(val_cols) == 0 or vals.shape[1] == len(val_cols)
    _pack_lib().zeth_pack_rows(
        m.ctypes.data, m.shape[1],
        bit_cols.ctypes.data, len(bit_cols),
        val_cols.ctypes.data, len(val_cols),
        packed.ctypes.data, packed.shape[1],
        vals.ctypes.data, int(r0), int(r1))


@dataclass
class SegmentInfo:
    index: int
    user_cycles: int
    paging_cycles: int
    po2: int
    exit_pc: int = 0                  # machine pc when the segment ended
    entry_regs: np.ndarray | None = None  # (32,) register file at segment start
    exit_regs: np.ndarray | None = None   # (32,) register file at segment end
    trace: np.ndarray | None = None   # (cycles, TRACE_WORDS) witness records
    # per-segment data-memory footprint (the RAM argument's boundary
    # lists): byte addrs (word-aligned), entry values, exit values
    mem_addrs: np.ndarray | None = None
    mem_pre: np.ndarray | None = None
    mem_post: np.ndarray | None = None
    halted: bool = False
    exit_code: int = 0


# One trace record per executed instruction or SYSMEM phantom row
# (see rv32im.cpp emit_trace):
# [pc, insn, rs1_val, rs2_val, rd_val, mem_addr, mem_word, flags]
# loads: mem_word = the full aligned word read; stores: the OLD word;
# SYSMEM rows: the word read/written, flags carry the stream tag.
TRACE_WORDS = 8

# trace flag bits (keep in sync with rv32im.cpp)
TR_MEM_LOAD = 1 << 0
TR_MEM_STORE = 1 << 1
TR_ECALL = 1 << 2
TR_SYSMEM = 1 << 3
SM_INPUT, SM_JOURNAL, SM_KECCAK_R, SM_KECCAK_W = 1, 2, 3, 4
SM_BIGINT_R, SM_BIGINT_W = 5, 6
SM_SHA_R, SM_SHA_W = 7, 8


@dataclass
class ExecResult:
    exit_code: int
    journal: bytes
    log: bytes
    user_cycles: int
    paging_cycles: int
    total_cycles: int
    keccak_calls: int
    bigint_calls: int = 0
    sha_calls: int = 0
    segments: list = field(default_factory=list)


def load_image(elf_bytes: bytes) -> tuple[int, np.ndarray, np.ndarray]:
    """Load an ELF's initial memory image: (entry_pc, addrs, words), sorted."""
    from .elf import read_entry

    lib = get_lib()
    h = lib.ex_create()
    try:
        rc = lib.ex_load_elf(h, elf_bytes, len(elf_bytes))
        if rc != 0:
            raise ValueError(f"ELF load failed (code {rc})")
        n = lib.ex_image_words(h, None, None, 0)
        addrs = (ctypes.c_uint32 * max(n, 1))()
        words = (ctypes.c_uint32 * max(n, 1))()
        lib.ex_image_words(h, addrs, words, n)
        a = np.frombuffer(addrs, dtype=np.uint32)[:n].astype(np.uint64)
        w = np.frombuffer(words, dtype=np.uint32)[:n].astype(np.uint64)
        order = np.argsort(a, kind="stable")
        return read_entry(elf_bytes), a[order].copy(), w[order].copy()
    finally:
        lib.ex_destroy(h)


def image_page_root(addrs: np.ndarray, words: np.ndarray) -> np.ndarray:
    """The initial memory image's page-tree root (hash/pagetree.py)."""
    from ..hash import pagetree as PT
    return PT.SparsePageTree(addrs, words).root()


def image_id_from_parts(entry_pc: int, addrs: np.ndarray,
                        words: np.ndarray) -> np.ndarray:
    """Image ID from an explicit memory image (also used by verifiers to
    bind a prover-supplied image back to the claimed ID)."""
    return image_id_from_root(entry_pc, image_page_root(addrs, words))


def image_id_from_root(entry_pc: int, page_root: np.ndarray) -> np.ndarray:
    from ..hash import poseidon2 as P2
    head = np.array([entry_pc & 0xFFFF, entry_pc >> 16], dtype=np.uint64)
    body = np.asarray(page_root, dtype=np.uint64).reshape(8)
    return P2.hash_rows_np(np.concatenate([head, body])[None])[0]


def compute_image_id(elf_bytes: bytes) -> np.ndarray:
    """Image ID: Poseidon2 digest of (entry pc, memory page-tree root).

    Plays the role of risc0-binfmt's image ID (SURVEY.md §2.2; used at
    reference crates/host/src/lib.rs:81): any change to the guest binary
    changes the ID, and the embedded page-tree root is the pre_root of
    the first segment's paging proof (the reference's MemoryImage
    digest). Returns (8,) uint64.
    """
    entry, a, w = load_image(elf_bytes)
    return image_id_from_parts(entry, a, w)


class Executor:
    """One guest execution: load ELF, provide input, run to completion."""

    def __init__(self, elf_bytes: bytes, input_bytes: bytes = b"",
                 segment_po2: int = 20, trace: bool = False):
        self.lib = get_lib()
        self.h = self.lib.ex_create()
        rc = self.lib.ex_load_elf(self.h, elf_bytes, len(elf_bytes))
        if rc != 0:
            raise ValueError(f"ELF load failed (code {rc})")
        # word-aligned input ABI: the in-circuit input binding is a word
        # stream, so the input is zero-padded to a word boundary
        input_bytes = input_bytes + b"\x00" * (-len(input_bytes) % 4)
        self.lib.ex_set_input(self.h, input_bytes, len(input_bytes))
        self.segment_po2 = segment_po2
        self._trace = trace
        if trace:
            self.lib.ex_trace_enable(self.h, 1)

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.ex_destroy(self.h)
            self.h = None

    def _grab_trace(self) -> np.ndarray:
        n = self.lib.ex_trace_len(self.h)
        ptr = self.lib.ex_trace_data(self.h)
        if n == 0:
            return np.zeros((0, TRACE_WORDS), dtype=np.uint32)
        buf = np.ctypeslib.as_array(ptr, shape=(n * TRACE_WORDS,))
        return buf.reshape(n, TRACE_WORDS).copy()

    def _grab_segment_mem(self):
        n = self.lib.ex_segment_mem(self.h, None, None, None, 0)
        if n == 0:
            z = np.zeros(0, dtype=np.uint32)
            return z, z.copy(), z.copy()
        addrs = (ctypes.c_uint32 * n)()
        pre = (ctypes.c_uint32 * n)()
        post = (ctypes.c_uint32 * n)()
        self.lib.ex_segment_mem(self.h, addrs, pre, post, n)
        return (np.frombuffer(addrs, dtype=np.uint32).copy(),
                np.frombuffer(pre, dtype=np.uint32).copy(),
                np.frombuffer(post, dtype=np.uint32).copy())

    def run(self, max_segments: int = 1 << 20) -> ExecResult:
        lib, h = self.lib, self.h
        limit = 1 << self.segment_po2
        # a single instruction may cost up to 1 + 2*PAGE_CYCLES, so smaller
        # segments cannot guarantee progress
        if limit <= 2 * PAGE_CYCLES + 1:
            raise ValueError(
                f"segment_po2={self.segment_po2} too small: budget {limit} "
                f"<= paging reserve {2 * PAGE_CYCLES + 1} (need po2 >= 11)")
        segments = []
        user0 = paging0 = 0
        for seg_idx in range(max_segments):
            regs_buf = (ctypes.c_uint32 * 32)()
            lib.ex_regs(h, regs_buf)
            entry_regs = np.frombuffer(regs_buf, dtype=np.uint32).copy()
            status = lib.ex_run(h, limit)
            lib.ex_regs(h, regs_buf)
            exit_regs = np.frombuffer(regs_buf, dtype=np.uint32).copy()
            seg_user = lib.ex_user_cycles(h) - user0
            seg_paging = lib.ex_paging_cycles(h) - paging0
            mem_addrs, mem_pre, mem_post = self._grab_segment_mem()
            info = SegmentInfo(
                index=seg_idx,
                user_cycles=seg_user,
                paging_cycles=seg_paging,
                po2=self.segment_po2,
                exit_pc=lib.ex_pc(h),
                entry_regs=entry_regs,
                exit_regs=exit_regs,
                trace=self._grab_trace() if self._trace else None,
                mem_addrs=mem_addrs, mem_pre=mem_pre, mem_post=mem_post,
                halted=status == ST_HALTED,
                exit_code=lib.ex_exit_code(h) if status == ST_HALTED else 0,
            )
            segments.append(info)
            user0 = lib.ex_user_cycles(h)
            paging0 = lib.ex_paging_cycles(h)
            if status == ST_HALTED:
                break
            if status == ST_ERROR:
                raise RuntimeError(f"guest fault at pc=0x{lib.ex_pc(h):08x}")
            if seg_user == 0:
                raise RuntimeError(
                    "segment made no progress (budget too small for one "
                    "instruction's worst-case paging cost)")
            lib.ex_new_segment(h)
        else:
            raise RuntimeError("segment limit exceeded")

        nk = lib.ex_keccak_inputs_len(h)
        if nk:
            kptr = lib.ex_keccak_inputs(h)
            self.keccak_inputs = np.ctypeslib.as_array(
                kptr, shape=(nk,)).reshape(-1, 25).copy()
        else:
            self.keccak_inputs = np.zeros((0, 25), dtype=np.uint64)
        nb = lib.ex_bigint_inputs_len(h)
        if nb:
            bptr = lib.ex_bigint_inputs(h)
            # 48 u32 words (a|b|m|r little-endian, 384-bit) per op
            self.bigint_inputs = np.ctypeslib.as_array(
                bptr, shape=(nb,)).reshape(-1, 48).astype(np.uint64)
        else:
            self.bigint_inputs = np.zeros((0, 48), dtype=np.uint64)
        ns = lib.ex_sha_inputs_len(h)
        if ns:
            sptr = lib.ex_sha_inputs(h)
            # 32 u32 words (state|block|out) per recorded compression
            self.sha_inputs = np.ctypeslib.as_array(
                sptr, shape=(ns,)).reshape(-1, 32).astype(np.uint64)
        else:
            self.sha_inputs = np.zeros((0, 32), dtype=np.uint64)

        journal = ctypes.create_string_buffer(lib.ex_journal_len(h))
        lib.ex_journal(h, journal)
        log = ctypes.create_string_buffer(lib.ex_log_len(h))
        lib.ex_log(h, log)
        user = lib.ex_user_cycles(h)
        paging = lib.ex_paging_cycles(h)
        return ExecResult(
            exit_code=lib.ex_exit_code(h),
            journal=journal.raw,
            log=log.raw,
            user_cycles=user,
            paging_cycles=paging,
            total_cycles=user + paging,
            keccak_calls=lib.ex_keccak_count(h),
            bigint_calls=lib.ex_bigint_count(h),
            sha_calls=lib.ex_sha_count(h),
            segments=segments,
        )
