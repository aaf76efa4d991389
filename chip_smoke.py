"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main paths are what bench.py measures for the JAX package: one
halting ``spin`` segment, and the first segment of the stateless-client
(EVM) guest validating the smaller fixture block, each executed by the
C++ executor, proved with its paging companion proof by
``zeth_tpu_torch.circuits.rv32im`` and verified; then the block's
accelerator batches, receipts of small guests through
``zeth_tpu_torch.zkvm``, and the recursion: the EVM segment and the
block's batches lifted and joined to one root proof, and succinct
receipts. Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (nvidia-smi); then
   ``[malloc]``: where a 256 MiB numpy array lands, on the main thread
   and in one worker thread (glibc's ``mallinfo2().hblkhd``, the bytes
   in mmapped blocks, read around it), with the glibc version and the
   peak host RSS. The port's import keeps blocks under 1 GiB off mmap
   (``zeth_tpu_torch/__init__.py``) and this script sets nothing, so a
   main-thread block that was mmapped fails the run;
2. build: every CUDA kernel of the path from the sources in the checkout
   (one nvcc per source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes, with both times and the
   least time the card could take for the same work: the leaf kernel
   (the Merkle leaves) at LEAF_SHAPES and at the rows on either side of
   each switch of its rule, with the mapping the rule takes and with
   each of its mappings forced (1, 8 and 32 lanes a row), all timed; the
   sponge kernel (one warp a row, the claims and publics digests) at
   SPONGE_SHAPES; then the sponge kernel in turns with the leaf kernel's
   8-lane mapping (another body of code: the rule gives one row the
   sponge kernel's own warp kernel) on one long row of 65,536 and on a
   random bigint claims row (2,479,200 limbs), equal, with the roofline
   and the chain bound of a row (its permutations times one
   permutation's critical path) at the SM clock read beside them. Then the exact int8 field products
   (``zeth_tpu_torch.mxu``, ``torch._int_mm`` on the tensor cores): the
   four-step coset LDE (``mxu.coset_lde_fs``, which no path takes)
   against the radix-2 ``prover._lde`` that every path takes, at each
   (rows, columns) of FS_SHAPES, and ``prover._eval_rows_at_points``
   (the streamed main group's query rows) against recomputing each
   queried coset, at the po2=24 streamed shape (2^24 x 84 coefficients,
   50 queries), bit for bit, both timed, with their bound;
4. oracle: a small spin segment proved on the card must hash to the seal
   digests in tests/fixtures/torch_port_seals.json (the CPU seals, which
   tests/test_torch_rv32im.py holds equal to the JAX package's), once on
   the resident path and once with the rv32im main group coset-streamed
   (``prover.STREAM_MAIN_BYTES`` set to 0 in this process, then restored;
   the aux group built on the card);
5. spin: a po2=16 spin segment and its paging proof, proved once with
   the prover's stage timers on (the breakdown), the kernels' launch
   counts read around this run alone, verified by ``verify_segments``
   against a ``ReceiptClaim`` as bench.py verifies it;
6. EVM front end: the guest ELF compiled from the checkout's C sources,
   the fixture block encoded, the guest executed with its trace;
7. aux: ``build_aux_device`` on the card against the host ``build_aux``
   on the EVM segment's main trace at po2=20, word for word (the host
   oracle is computed in a process of its own from phase 3 on);
8. EVM: ``prove_segments`` of that segment at po2=20, once, with the
   stage timers on (launch counts, the leaf kernel's by (rows, cols), and
   peak memory read around it; then the leaf kernel timed once at each
   of those shapes, whose launches x ms is its time in the segment);
   then the segment's main trace uploaded
   bit-packed (``prover._upload_main``: the C packer, the unpack on the
   card) and plain (``prover._upload_std``), timed, word for word equal;
   both proofs verified as bench.py verifies them;
9. accel: the block's keccak, bigint and sha batches (every accelerator
   call of the execution, built as ``zkvm.LocalProver`` builds them),
   each proved on the card once with the stage timers on (launches, peak
   memory read around it), verified, its claims digest held equal
   to the digest of the verified IO (and the block's bigint claims row
   through the leaf kernel's 8-lane mapping equal to the sponge kernel's
   digest of it, ``sponge_row``'s); segment 0's bound IO must be a
   prefix of the proof-bound streams (the resolve); a flipped keccak
   seal word is rejected; small batches must hash to the fixture digests;
10. receipt: ``zkvm.LocalProver`` and ``Receipt.verify`` on four guests
   (echo, keccak, bigint, sha), each with one tamper that must be
   rejected;
11. succinct: (a) EVM segment 0's proof and its paging proof lifted into
   the recursion circuit and joined to one root proof by
   ``succinct.aggregate_segments`` (the block's batches are not lifted:
   cut for time) and verified by ``verify_root_segments``, with a
   flipped root-seal word and a forged d0 binding rejected; one line per
   recursion proof with its host and prove seconds, leaf launches and
   peak memory; (b) ``zkvm.LocalProver`` under ``ZETH_SUCCINCT=1`` on a
   bigint guest (its segment pair and its bigint batch lifted and
   folded, one line per recursion proof), the receipt verified and
   tampered (a forged d0 binding, a forged paging public, a flipped
   root-seal word, a flipped accelerator public); the launch counts are
   read around (a) and (b); (c) after that read, the paging proof's lift
   of (a) proved again with its main group coset-streamed (the recursion
   AIR's host aux, the program compiled already), whose seal must equal
   the resident one word for word. The streamed path's launches are
   those of (c) and of phase 4's streamed prove, each counted around its
   own run;
12. cli: the port's command line as a user runs it. (a) ``cli
   validate`` of the smaller fixture block on the host's native EVM
   engine (run in a process of its own from phase 3 on, as it needs no
   card), which must print the block hash its file is named by; (b)
   ``cli prove`` of block 101 (tests/fixtures/cli: one segment, a keccak
   and a sha batch) at the default ``--segment-po2 20`` on the card, which
   returns 0 only when the receipt verifies against the image ID
   computed from the guest ELF and the journal equals the block hash;
   its prove and verify seconds, segments, cycles, leaf launches and
   peak memory; then a flipped segment-seal word and a flipped
   keccak-seal word must be rejected;
13. mesh: the multi-device path, several ranks on the one card
   (``parallel.multihost.launch``: one process a rank, gloo, every
   rank's shards on the card). (a) MESH_FIXTURE_RANKS ranks prove phase
   4's fixture spin segment with ``prove_segments(mesh=...)``, whose
   seals must hash to the fixture digests; (b) MESH_SPIN_RANKS ranks
   prove phase 5's po2=16 spin segment, whose seals must equal phase 5's
   word for word and verify; every rank's seals must equal every other
   rank's. Per rank: the prove seconds, leaf launches (the ``mesh``
   path's, summed over ranks), peak device memory, the collectives'
   calls, bytes and seconds and their backend; for (b) also the main
   group's sharded LDE and commit against the unsharded ``_lde`` and
   ``commit_rows`` at the same shape, with the same root;
14. a ``{"kernels": [...]}`` line, the card line, and the final
   ``{"ok": true, ...}`` line.

Each phase prints its seconds (``[phase N]``), on standard error too.
The lines of each path's seconds also give the process's peak host RSS
so far (``ru_maxrss``); a mesh rank's line gives its process's, and the
parent's peak that the spawned rank started from.

The script needs a CUDA card: without one it exits non-zero before any
result. It imports no jax and nothing of the JAX package (``zeth_tpu``).
It must finish within 1200 s, the kernels' build included, on hosts
whose speed spreads its time by up to 1.7x (one H100 80GB HBM3 at 700 W
took 949 s for this script before the cuts below, and a slower host
more than 1200 s), so it aims at about half of that: the two host-only
jobs above run beside the card's phases, each path is proved once (the
stage timers on), and the depth of a path is cut before a check is
dropped (the spin path at po2=16; in 11a no batch lifted; in 11b one
receipt of one segment). Every AIR with a ``main_bit_mask`` is uploaded
bit-packed on every path.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import io
import json
import multiprocessing
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_seals.json")

# the EVM segment's size (the reference's, and bench.py's BASELINE) and
# the spin path's, cut in depth to keep the script inside its time limit
PO2 = 20
SPIN_PO2 = 16

# NVIDIA's data sheet for the H100 SXM: HBM bytes/s, and float32 outside
# the tensor cores, 67e12 operations/s (an FMA counts as two): 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz instructions. A scheduler issues one
# warp instruction a cycle, so no mix of instructions runs faster than
# PEAK_ISSUE. Integer instructions go to two pipes of 16 lanes a
# scheduler each, PEAK_PIPE apiece: integer multiplies (IMAD, IMUL) to
# the FMA pipe, selects, min/max and logic to the ALU pipe; an addition
# issues on either (ptxas writes IADD3 or IMAD.IADD).
PEAK_BYTES = 3.35e12
PEAK_ISSUE = 67e12 / 2
PEAK_PIPE = 67e12 / 4
# dense int8 tensor-core operations per second (an FMA counts as two)
PEAK_INT8 = 1979e12

# the aux group's 27 blocks of 4 columns, in the order they are laid out
AUX_BLOCKS = ["t", "u", "acc", "t_r1", "t_r2", "t_w", "t_a7", "s0", "s1",
              "s2", "s3", "racc", "mu_r", "mu_w", "msort0", "msort1",
              "macc", "li", "lf", "liacc", "lfacc", "r_j", "r_k", "r_b",
              "r_sh", "r_re", "r_rx"]

# the Poseidon2 leaf kernel's shapes as (rows, cols, kernel calls, plain
# calls) timed: edge cases, the rv32im main group at po2=10, the keccak
# and bigint batches' main LDEs, one long row (4,096 permutations one
# after another), the recursion circuit's main LDE at po2=19, and the
# rv32im main group at po2=20 (the headline)
LEAF_SHAPES = [(1, 3, 20, 3), (7, 16, 20, 3), (1000, 37, 20, 3),
               (4096, 1009, 20, 3), (1 << 14, 4161, 5, 1),
               (1 << 17, 3410, 3, 1), (1, 65536, 3, 1),
               (1 << 21, 84, 5, 1), (1 << 22, 1009, 3, 1)]
# the leaf kernel's mappings, in lanes a row, each held against hash_rows
# and timed at every shape beside the one its rule takes; the shapes on
# either side of the rule's switches are added at the rv32im main width
LEAF_MAPPINGS = (1, 8, 32)
SWITCH_COLS = 1009
# the bigint batch's claims row: 25,825 ops x 96 limbs
CLAIMS_ROW = 25825 * 96
# the Poseidon2 sponge kernel's (rows, cols, kernel calls, plain calls)
# against hash_rows: edge cases and one long row, whose plain result the
# leaf check has computed already (plain calls 0: reused)
SPONGE_SHAPES = [(1, 3, 20, 3), (1, 16, 20, 3), (1, 17, 20, 3),
                 (7, 16, 20, 3), (1000, 37, 20, 3), (1, 65536, 3, 0)]
# the sponge kernel's critical path of one permutation, in dependent
# instructions of the warp permutation (poseidon2.cuh) as ptxas compiles
# it for sm_90a: a Montgomery product 5 (IMAD.WIDE.U32, IMAD, IMAD.HI.U32,
# IMAD.X, VIADDMNMX), a modular addition 2 (IADD3, VIADDMNMX), M4's 64-bit dot 3
# and its reduction 4, a shuffle, warp reduction or select 1; each
# counted at DEP_CYCLES, the latency between dependent integer
# instructions on Hopper (a shuffle or reduction waits longer, so the bound
# is a least time)
MUL, ADD, XCHG, DOT, REDUCE = 5, 2, 1, 3, 4
SBOX = 3 * MUL                                      # x^4 * x^3
EXT_LAYER = (XCHG + DOT + REDUCE                    # M4 on each block
             + XCHG + 3 * ADD + ADD + XCHG)         # block sums, add, lanes >= 24
EXT_ROUND = ADD + SBOX + EXT_LAYER
INT_ROUND = SBOX + MUL + ADD                        # cell 0's chain
PERM_CHAIN = (ADD + EXT_LAYER + 8 * EXT_ROUND       # absorb, external rounds
              + XCHG + ADD + 21 * INT_ROUND + XCHG)  # internal rounds
DEP_CYCLES = 4

# the (rows, columns) of the groups the reference prover gives its
# four-step LDE (2^15 <= rows < 2^19, at most 256 columns) on these paths:
# a po2=18 rv32im segment's control, aux and check groups, the po2=15
# bigint batch's control, aux and check, the po2=16 paging proofs' (the
# EVM segment's, block 101's), and the po2=18 recursion proofs' control,
# main, aux and check groups; the port's prover takes the radix-2 there
FS_SHAPES = [(1 << 18, 8), (1 << 18, 108), (1 << 18, 16),
             (1 << 15, 2), (1 << 15, 4), (1 << 15, 16),
             (1 << 16, 61), (1 << 16, 24), (1 << 16, 16),
             (1 << 18, 70), (1 << 18, 84), (1 << 18, 40)]
# the po2=24 streamed main group's coefficients (rows, columns) whose
# rows at the proof's query points _eval_rows_at_points evaluates
EVAL_SHAPE = (1 << 24, 84)
# phase 13's rank counts on the one card: (a) phase 4's fixture segment,
# (b) phase 5's po2=16 spin segment
MESH_FIXTURE_RANKS = 4
MESH_SPIN_RANKS = 2

# each kernel's main path names the path whose launches the kernels line
# gives as "launches"
KERNELS = {
    "poseidon2_leaf": {
        "route": "cuda",
        "source": "zeth_tpu_torch/kernels/csrc/poseidon2_leaf.cu",
        "replaces": "zeth_tpu/pallas/poseidon2.py:110",
        "main_path": "evm",
    },
    "poseidon2_sponge": {
        "route": "cuda",
        "source": "zeth_tpu_torch/kernels/csrc/poseidon2_sponge.cu",
        "replaces": "none: the one-row form of "
                    "zeth_tpu/pallas/poseidon2.py:110's function, whose "
                    "digests the JAX package computes on the host",
        "main_path": "accel",
    },
}
# the paths that hash no claims or publics digest launch the leaf kernel
# alone; every other path launches both
LEAF_ONLY = ("poseidon2_leaf",)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def host_rss_gib() -> float:
    """This process's peak resident set so far (Linux gives KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def mmapped_mib(nbytes: int, in_thread: bool = False) -> float:
    """MiB that glibc mmapped for one numpy array of `nbytes`, made on
    this thread or on a new one: ``mallinfo2().hblkhd``, the bytes in
    mmapped blocks, read around it."""
    import ctypes
    libc = ctypes.CDLL("libc.so.6")
    # mallinfo2 (glibc 2.33) has size_t fields; mallinfo's int fields
    # still hold these sizes
    info = getattr(libc, "mallinfo2", None) or libc.mallinfo
    field = ctypes.c_size_t if hasattr(libc, "mallinfo2") else ctypes.c_int

    class Mallinfo(ctypes.Structure):
        _fields_ = [(f, field) for f in (
            "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
            "fsmblks", "uordblks", "fordblks", "keepcost")]
    info.restype = Mallinfo
    out = []

    def measure() -> None:
        before = info().hblkhd
        a = np.empty(nbytes, np.uint8)
        out.append((info().hblkhd - before) / 2**20)
        del a

    if in_thread:
        t = threading.Thread(target=measure)
        t.start()
        t.join()
    else:
        measure()
    return out[0]


def malloc_check() -> None:
    """``[malloc]``: where one 256 MiB numpy array lands, made on the main
    thread and in one worker thread. Fails if the main-thread block was
    mmapped: the port's import did not take. A thread's arena mmaps any
    block over its 64 MiB heap whatever the threshold, so the worker's
    figure is reported, not checked."""
    version = os.confstr("CS_GNU_LIBC_VERSION")
    main_mib = mmapped_mib(256 << 20)
    worker_mib = mmapped_mib(256 << 20, in_thread=True)
    log(f"[malloc] {version}: a 256 MiB numpy array mmapped "
        f"{main_mib:.3f} MiB on the main thread, {worker_mib:.3f} MiB in a "
        f"worker thread; peak host RSS {host_rss_gib():.3f} GiB")
    if main_mib > 0:
        raise SystemExit(f"malloc: {version} mmapped a 256 MiB block made "
                         "on the main thread; the port's M_MMAP_THRESHOLD "
                         "did not take")


def sha(words) -> str:
    return hashlib.sha256(np.asarray(words, dtype="<u4").tobytes()).hexdigest()


def cuda_ms(fn, reps: int) -> tuple:
    """(result of the last call, mean ms per call) by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def leaf_bound_ms(rows: int, cols: int) -> tuple:
    """(least ms the card could take for the leaf sponge, what bounds it).

    Bytes: the matrix read once, the digests written once. Operations: one
    width-24 permutation per 16 absorbed columns; a permutation is 8 full
    and 21 partial rounds, 8*24*4 + 21*(4+24) Montgomery products and
    9*128 + 213 + 21*47 + 16 modular additions. A product is three
    integer multiplies (a b, m = t p' mod 2^32, m p), one addition and one
    select (the conditional subtract); a modular addition one addition and
    one select. The multiplies need the FMA pipe and the selects the ALU
    pipe, PEAK_PIPE each; all of them issue at PEAK_ISSUE. The operations'
    time is the longest of the three."""
    perms = rows * -(-cols // 16)
    products = 8 * 24 * 4 + 21 * (4 + 24)
    additions = 9 * 128 + (8 * 24 + 21) + 21 * 47 + 16
    multiplies = 3 * products
    selects = products + additions
    total = multiplies + selects + products + additions
    ops_ms = perms * max(multiplies / PEAK_PIPE, selects / PEAK_PIPE,
                         total / PEAK_ISSUE) * 1e3
    bytes_ms = (rows * cols * 4 + rows * 8 * 4) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def sm_mhz() -> int:
    """The card's SM clock now, as nvidia-smi reads it."""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.split()[0])


def chain_bound_ms(cols: int, mhz: int) -> float:
    """The least ms one warp can take for the sponge of a row of `cols` at
    `mhz`: its permutations, each waiting on the last, times PERM_CHAIN
    dependent instructions of DEP_CYCLES each."""
    return max(1, -(-cols // 16)) * PERM_CHAIN * DEP_CYCLES / mhz * 1e-3


def leaf_shapes(dev, card, P, gen, shapes, plain_rows=None,
                keep=()) -> tuple:
    """The leaf kernel against hash_rows at each (rows, cols, kernel
    calls, plain calls) of `shapes`, timed at each: with the mapping its
    rule takes, and with each of LEAF_MAPPINGS forced
    (``_leaf_hash_lanes``), every one held equal. The plain version
    hashes the first `plain_rows` rows where that is fewer (the whole
    matrix's int64 state would not fit): then it is held equal there and
    its time is not the shape's. The bound is ``leaf_bound_ms``'s at
    every shape; a one-row launch is further bound by its chain
    (``chain_bound_ms``, given where the sponge kernel checks the same
    row). Returns (max_abs_err, one dict per shape, {(rows, cols):
    (matrix, plain digests)} for the shapes in `keep`)."""
    from zeth_tpu_torch.hash import poseidon2 as P2
    worst, out, kept = 0, [], {}
    for rows_n, cols, reps, plain_reps in shapes:
        rows = torch.randint(0, P, (rows_n, cols), dtype=torch.int32,
                             device=dev, generator=gen)
        part = rows[:plain_rows] if plain_rows else rows
        whole = part.shape[0] == rows_n
        # warm both up, except the plain version where one call takes
        # seconds (it has nothing to compile)
        P2.leaf_hash(rows)
        if plain_reps > 1:
            P2.hash_rows(part)
        torch.cuda.synchronize()
        got, ms = cuda_ms(lambda: P2.leaf_hash(rows), reps)
        want, plain_ms = cuda_ms(lambda: P2.hash_rows(part), plain_reps)
        n = part.shape[0]
        lanes_ms = {}
        for lanes in (None, *LEAF_MAPPINGS):
            if lanes is not None:
                P2._leaf_hash_lanes(rows, lanes)
                got, lanes_ms[lanes] = cuda_ms(
                    lambda: P2._leaf_hash_lanes(rows, lanes), reps)
            err = int((got[:n].long() - want.long()).abs().max())
            if got.shape != (rows_n, 8) or not torch.equal(got[:n], want):
                raise SystemExit(
                    f"poseidon2_leaf ({lanes or 'the rule'}'s mapping) "
                    f"disagrees with hash_rows at {(rows_n, cols)}: "
                    f"max_abs_err {err}")
            worst = max(worst, err)
        bound, by = leaf_bound_ms(rows_n, cols)
        mapping = P2._leaf_mapping(rows_n, dev)
        out.append({"rows": rows_n, "cols": cols, "ms": ms,
                    "plain_ms": plain_ms if whole else None,
                    "bound_ms": bound, "bound_by": by, "lanes": mapping,
                    "lanes_ms": lanes_ms})
        log(f"{card} | [kernels] poseidon2_leaf ({rows_n}, {cols}): equal"
            + ("" if whole else f" on the first {n} rows")
            + f", kernel {ms:.3f} ms ({mapping} lanes a row; "
            + ", ".join(f"{k}: {v:.3f} ms" for k, v in lanes_ms.items())
            + "), plain "
            + (f"{plain_ms:.3f} ms" if whole else "not measured")
            + f", bound {bound:.6f} ms by {by} ({bound / ms:.1%} of it)")
        if (rows_n, cols) in keep:
            kept[(rows_n, cols)] = (rows, want, plain_ms)
        del rows, part, got, want
        torch.cuda.empty_cache()
    return worst, out, kept


def switch_shapes(dev) -> list:
    """LEAF_SHAPES-style entries for the rows on either side of each
    switch of the leaf kernel's rule on this card (found by asking the
    rule, ``poseidon2_leaf_mapping``), at SWITCH_COLS columns."""
    from zeth_tpu_torch.hash import poseidon2 as P2
    shapes, lo = [], 1
    hi = 1 << 26
    while P2._leaf_mapping(lo, dev) != P2._leaf_mapping(hi, dev):
        a, b = lo, hi                        # the first rows that change it
        while b - a > 1:
            mid = (a + b) // 2
            if P2._leaf_mapping(mid, dev) == P2._leaf_mapping(lo, dev):
                a = mid
            else:
                b = mid
        shapes += [(a, SWITCH_COLS, 5, 1), (b, SWITCH_COLS, 5, 1)]
        lo = b
    return shapes


def leaf_time_by_shape(dev, card, P, gen, tag: str, shapes: dict) -> float:
    """The leaf kernel timed once at each (rows, cols) a path launched it
    on (`shapes`: {(rows, cols): launches}); prints each and returns the
    path's leaf time, the sum of launches x ms."""
    from zeth_tpu_torch.hash import poseidon2 as P2
    total = 0.0
    for (rows_n, cols), n in sorted(shapes.items()):
        rows = torch.randint(0, P, (rows_n, cols), dtype=torch.int32,
                             device=dev, generator=gen)
        P2.leaf_hash(rows)
        _, ms = cuda_ms(lambda: P2.leaf_hash(rows), 1)
        total += n * ms
        log(f"{card} | [{tag}] leaf launches at ({rows_n}, {cols}): {n} x "
            f"{ms:.3f} ms ({P2._leaf_mapping(rows_n, dev)} lanes a row)")
        del rows
    torch.cuda.empty_cache()
    log(f"{card} | [{tag}] leaf kernel time of the path: {total:.3f} ms "
        f"over {sum(shapes.values())} launches")
    return total


def turns(card, what: str, fns: dict, reps: dict) -> dict:
    """Each of `fns` ({name: call}) timed in turns, first, second,
    second, first (CUDA events, `reps[name]` calls a turn), the SM clock
    read after each turn. Returns {name: (last result, [ms, ms])} and, as
    "mhz", the clocks read."""
    a, b = list(fns)
    got, clocks = {a: [None, []], b: [None, []]}, []
    for name in (a, b, b, a):
        got[name][0], ms = cuda_ms(fns[name], reps[name])
        got[name][1].append(ms)
        clocks.append(sm_mhz())
        log(f"{card} | [kernels] {what} {name}: {ms:.3f} ms "
            f"(SM clock {clocks[-1]} MHz)")
    return {**{k: tuple(v) for k, v in got.items()}, "mhz": clocks}


def check_poseidon2_kernels(dev, card, P) -> dict:
    """The leaf kernel against hash_rows at every shape of LEAF_SHAPES;
    the sponge kernel against hash_rows at every shape of SPONGE_SHAPES
    (at (1, 65536) against the leaf check's plain result); then on the
    one-row shapes, (1, 65536) and a random bigint claims row, the sponge
    kernel in turns with the leaf kernel's 8-lane mapping (leaf, sponge,
    sponge, leaf), which must hash alike. The rule gives a single row the
    sponge kernel's own warp kernel, so the 8-lane mapping is the leaf
    kernel's witness there. Returns the kernels' results by name."""
    from zeth_tpu_torch.hash import poseidon2 as P2
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    worst, shapes, kept = leaf_shapes(dev, card, P, gen, LEAF_SHAPES,
                                      keep={(1, 65536)})
    switch_worst, switch, _ = leaf_shapes(dev, card, P, gen,
                                          switch_shapes(dev), plain_rows=4096)
    worst = max(worst, switch_worst)
    sworst, sshapes = 0, []
    for rows_n, cols, reps, plain_reps in SPONGE_SHAPES:
        if plain_reps:
            rows = torch.randint(0, P, (rows_n, cols), dtype=torch.int32,
                                 device=dev, generator=gen)
            P2.hash_rows(rows)
            want, plain_ms = cuda_ms(lambda: P2.hash_rows(rows), plain_reps)
        else:
            rows, want, plain_ms = kept[(rows_n, cols)]
        P2.sponge_hash(rows)
        got, ms = cuda_ms(lambda: P2.sponge_hash(rows), reps)
        err = int((got.long() - want.long()).abs().max())
        if got.shape != (rows_n, 8) or not torch.equal(got, want):
            raise SystemExit(f"poseidon2_sponge disagrees with hash_rows at "
                             f"{(rows_n, cols)}: max_abs_err {err}")
        sworst = max(sworst, err)
        bound, by = leaf_bound_ms(rows_n, cols)
        sshapes.append({"rows": rows_n, "cols": cols, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by})
        log(f"{card} | [kernels] poseidon2_sponge ({rows_n}, {cols}): equal, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            + (" (the leaf check's)" if not plain_reps else "")
            + f", bound {bound:.6f} ms by {by}")
    # the one-row shapes in turns; the claims row's digest is held by
    # the accel phase on the block's real row
    claims = torch.randint(0, P, (1, CLAIMS_ROW), dtype=torch.int32,
                           device=dev, generator=gen)
    for rows, reps in ((kept[(1, 65536)][0], (3, 3)), (claims, (1, 1))):
        cols = rows.shape[1]
        t = turns(card, f"(1, {cols})",
                  {"poseidon2_leaf": lambda: P2._leaf_hash_lanes(rows, 8),
                   "poseidon2_sponge": lambda: P2.sponge_hash(rows)},
                  dict(zip(("poseidon2_leaf", "poseidon2_sponge"), reps)))
        if not torch.equal(t["poseidon2_leaf"][0], t["poseidon2_sponge"][0]):
            raise SystemExit(f"poseidon2_sponge disagrees with poseidon2_leaf "
                             f"(8 lanes a row) at (1, {cols})")
        mhz = max(t["mhz"])
        bound, by = leaf_bound_ms(1, cols)
        chain = chain_bound_ms(cols, mhz)
        leaf_ms = sum(t["poseidon2_leaf"][1]) / 2
        ms = sum(t["poseidon2_sponge"][1]) / 2
        row = {"rows": 1, "cols": cols, "bound_ms": bound, "bound_by": by,
               "chain_bound_ms": chain, "sm_mhz": t["mhz"]}
        if cols == CLAIMS_ROW:
            shapes.append({**row, "ms": leaf_ms, "plain_ms": None,
                           "lanes": 8})
            sshapes.append({**row, "ms": ms, "plain_ms": None})
        else:
            sshapes[-1].update(row, ms=ms)
            next(x for x in shapes if (x["rows"], x["cols"]) == (1, cols)) \
                .update(row, turns_8_lanes_ms=leaf_ms)
        log(f"{card} | [kernels] (1, {cols}) in turns: poseidon2_sponge "
            f"{ms:.3f} ms against poseidon2_leaf on 8 lanes {leaf_ms:.3f} ms "
            f"({ms / leaf_ms:.3f} of it), equal; "
            f"{ms / max(1, -(-cols // 16)) * 1e3:.3f} us a permutation; "
            f"bounds: chain {chain:.3f} ms ({PERM_CHAIN} dependent "
            f"instructions a permutation x {DEP_CYCLES} cycles at "
            f"{mhz} MHz), roofline {bound:.6f} ms by {by}")
    del claims, kept
    torch.cuda.empty_cache()
    # no single PyTorch call computes a Poseidon2 sponge
    main = shapes[len(LEAF_SHAPES) - 1]
    head = sshapes[len(SPONGE_SHAPES) - 1]
    return {
        "poseidon2_leaf": {
            "max_abs_err": worst, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shapes": shapes, "switch_shapes": switch},
        "poseidon2_sponge": {
            "max_abs_err": sworst, "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "chain_bound_ms": head["chain_bound_ms"], "library_ms": None,
            "shapes": sshapes},
    }


def fs_bound_ms(n: int, cols: int) -> tuple:
    """(least ms the card could take for a four-step coset LDE, what
    bounds it). Operations: five size-n transforms (one inverse, four
    forward), each two small-matrix stages of 16 int8 digit products,
    32 * (n1 + n2) * n * cols int8 operations a transform. Bytes: the
    (n, cols) input read once, the (4n, cols) result written once."""
    from zeth_tpu_torch import mxu
    n1, n2 = mxu._split_n(n)
    ops_ms = 5 * 32 * (n1 + n2) * n * cols / PEAK_INT8 * 1e3
    bytes_ms = 5 * n * cols * 4 / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"


def check_four_step(dev, card, P, gen, shapes) -> list:
    """The four-step coset LDE (``mxu.coset_lde_fs``) against the radix-2
    ``prover._lde`` on the same Montgomery input at each (rows, columns)
    of `shapes`, bit for bit; both timed (CUDA events, means of 2 after
    a warm call). Returns one dict per shape."""
    from zeth_tpu_torch import mxu
    from zeth_tpu_torch.zkp import prover
    out = []
    for n, cols in shapes:
        x = torch.randint(0, P, (n, cols), dtype=torch.int32, device=dev,
                          generator=gen)
        mxu.coset_lde_fs(x)
        prover._lde(x, std=False)
        got, ms = cuda_ms(lambda: mxu.coset_lde_fs(x), 2)
        want, r2_ms = cuda_ms(lambda: prover._lde(x, std=False), 2)
        if not torch.equal(got, want):
            err = int((got.long() - want.long()).abs().max())
            raise SystemExit(f"four-step LDE disagrees with the radix-2 at "
                             f"{(n, cols)}: max_abs_err {err}")
        bound, by = fs_bound_ms(n, cols)
        out.append({"rows": n, "cols": cols, "ms": ms, "radix2_ms": r2_ms,
                    "bound_ms": bound, "bound_by": by})
        log(f"{card} | [mxu] four-step LDE ({n}, {cols}): equal to the "
            f"radix-2, four-step {ms:.3f} ms, radix-2 {r2_ms:.3f} ms, "
            f"bound {bound:.3f} ms by {by} ({bound / ms:.1%} of it)")
        del x, got, want
    torch.cuda.empty_cache()
    return out


def coset_query_rows(coeffs1, n: int, qs):
    """The plain counterpart of ``prover._eval_rows_at_points``: each
    coset of the LDE that holds a query recomputed by the radix-2 NTT
    (``prover._coset_eval``) and its rows gathered. (Q, c) Montgomery."""
    from zeth_tpu_torch.zkp import prover
    qa = torch.as_tensor(np.asarray(qs, np.int64), device=coeffs1.device)
    rows = torch.empty((len(qs), coeffs1.shape[1]), dtype=torch.int32,
                       device=coeffs1.device)
    for r in range(prover.BLOWUP):
        sel = torch.nonzero(qa % prover.BLOWUP == r).flatten()
        if sel.numel():
            ev = prover._coset_eval(coeffs1, r, n)
            rows[sel] = ev.index_select(0, qa[sel] // prover.BLOWUP)
            del ev
    return rows


def check_eval_rows(dev, card, P, gen) -> dict:
    """``prover._eval_rows_at_points`` against ``coset_query_rows`` at
    EVAL_SHAPE and the proof's query count, bit for bit, each timed once
    after a warm call (the recompute's warm call is one column)."""
    from zeth_tpu_torch import hostmath as H
    from zeth_tpu_torch.zkp import fri, prover
    n, c = EVAL_SHAPE
    q = fri.QUERIES
    coeffs = torch.randint(0, P, (n, c), dtype=torch.int32, device=dev,
                           generator=gen)
    qs = np.random.default_rng(24).integers(0, 4 * n, q).tolist()
    w4n = H.rou_fwd(4 * n)
    pts = prover._to_dev(np.array([pow(w4n, i, P) for i in qs], np.uint64),
                         dev)
    prover._eval_rows_at_points(coeffs, pts, n)
    for r in range(prover.BLOWUP):        # the coset tables, built once
        prover._coset_eval(coeffs[:, :1], r, n)
    got, ms = cuda_ms(lambda: prover._eval_rows_at_points(coeffs, pts, n), 1)
    want, rc_ms = cuda_ms(lambda: coset_query_rows(coeffs, n, qs), 1)
    if not torch.equal(got, want):
        err = int((got.long() - want.long()).abs().max())
        raise SystemExit(f"_eval_rows_at_points disagrees with the coset "
                         f"recompute: max_abs_err {err}")
    ops_ms = 32 * q * n * c / PEAK_INT8 * 1e3
    bytes_ms = (n * c + q * c) * 4 / PEAK_BYTES * 1e3
    bound, by = max(ops_ms, bytes_ms), \
        "operations" if ops_ms >= bytes_ms else "bytes"
    log(f"{card} | [mxu] _eval_rows_at_points ({q} queries of ({n}, {c}) "
        f"coefficients): equal to the coset recompute, {ms:.3f} ms against "
        f"{rc_ms:.3f} ms, bound {bound:.3f} ms by {by} "
        f"({bound / ms:.1%} of it)")
    del coeffs, got, want
    torch.cuda.empty_cache()
    return {"queries": q, "rows": n, "cols": c, "ms": ms,
            "recompute_ms": rc_ms, "bound_ms": bound, "bound_by": by}


def check_upload(dev, card, air, main) -> None:
    """The EVM main trace uploaded bit-packed (``prover._upload_main``)
    and plain (``prover._upload_std``), each timed to a synchronise
    (the packed one with its host buffers already made), word for word
    equal."""
    from zeth_tpu_torch.zkp import prover
    torch.cuda.synchronize()
    t0 = time.time()
    got = prover._upload_main(air, main, dev)
    torch.cuda.synchronize()
    packed_s = time.time() - t0
    t0 = time.time()
    want = prover._upload_std(main, dev)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    if not torch.equal(got, want):
        bad = int((got != want).any(dim=0).nonzero()[0])
        raise SystemExit(f"the packed upload differs from the plain one "
                         f"first in main column {bad}")
    spec, mask, n_bits, n_vals = prover._pack_spec(air.name)
    n = main.shape[0]
    log(f"{card} | [evm] main upload ({n}, {main.shape[1]}): bit-packed "
        f"{packed_s:.3f} s ({(n_bits + 31) // 32} words + {n_vals} values "
        f"a row, {n * ((n_bits + 31) // 32 + n_vals) * 4 / 2**30:.2f} GiB), "
        f"plain {plain_s:.3f} s ({n * main.shape[1] * 4 / 2**30:.2f} GiB); "
        f"equal word for word")
    del got, want
    torch.cuda.empty_cache()


def spin_segment(spin_iters: int, segment_po2: int):
    """(segment, image addrs, image words, entry pc, ReceiptClaim) of a
    spin guest that halts in one segment."""
    from zeth_tpu_torch.executor import (Executor, compute_image_id, guests,
                                         load_image)
    from zeth_tpu_torch.zkvm import ReceiptClaim
    elf = guests.spin(spin_iters)
    entry, ia, iw = load_image(elf)
    res = Executor(elf, segment_po2=segment_po2, trace=True).run()
    if len(res.segments) != 1:
        raise SystemExit(f"spin({spin_iters}) gave {len(res.segments)} "
                         "segments, expected one halting segment")
    claim = ReceiptClaim(image_id=compute_image_id(elf),
                         journal_digest=hashlib.sha256(res.journal).digest(),
                         exit_code=res.exit_code)
    return res.segments[0], ia, iw, entry, claim


def verify_pair(dev, seal, pg_seal, ia, iw) -> tuple:
    """Both proofs with the port's verifier, as bench.py checks an EVM
    segment: the paging proof, the rv32im proof bound to it, then g4.
    The control roots are recomputed on the card. Returns the seconds of
    the two verifications."""
    from zeth_tpu_torch.circuits.paging import PagingAir
    from zeth_tpu_torch.circuits.rv32im import Rv32imAir
    from zeth_tpu_torch.zkp import proof as proof_mod
    from zeth_tpu_torch.zkp import verifier
    proof, pg_proof = proof_mod.decode(seal), proof_mod.decode(pg_seal)
    pg_pubs = [int(p) for p in pg_proof.publics]
    ppg = PagingAir.parse_publics(pg_pubs)
    t0 = time.time()
    verifier.verify(PagingAir(), pg_proof, pg_pubs, device=dev)
    t1 = time.time()
    sampled = verifier.verify(
        Rv32imAir(ia, iw), proof, [int(p) for p in proof.publics],
        derived_extra={"d0": ppg["d0"], "d1": ppg["d1"]},
        extra_mix=pg_proof.roots["main"], device=dev)
    if not (np.asarray(sampled[4], np.uint64) == ppg["g4"]).all():
        raise SystemExit("paging proof's g4 differs from the rv32im proof's")
    return t1 - t0, time.time() - t1


def evm_segment():
    """The stateless-client guest on the smaller fixture block, as
    bench.py runs it: (first segment, image addrs, image words, result,
    executor). The executor holds the accelerator calls' inputs."""
    from zeth_tpu_torch.app import guest_input
    from zeth_tpu_torch.app.chainspec import MAINNET
    from zeth_tpu_torch.app.host import StatelessInput
    from zeth_tpu_torch.executor import Executor, load_image
    paths = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                          "input_0x*.json")),
                   key=os.path.getsize)
    if not paths:
        raise SystemExit("no fixture block under tests/fixtures")
    with open(paths[0]) as f:
        inp = StatelessInput.from_json(json.load(f))
    # no cached ELF: the guest is compiled from the checkout's sources
    shutil.rmtree(os.path.join(ROOT, "zeth_tpu_torch", "guest", ".build"),
                  ignore_errors=True)
    t0 = time.time()
    elf = guest_input.build_stateless_elf()
    log(f"[evm] guest ELF compiled from the checkout's C sources by "
        f"zeth_tpu_torch.cc: {len(elf)} bytes, sha256 "
        f"{hashlib.sha256(elf).hexdigest()[:16]}, {time.time() - t0:.1f} s")
    _, ia, iw = load_image(elf)
    raw = guest_input.encode_guest_input(inp, MAINNET.chain_id)
    t0 = time.time()
    ex = Executor(elf, input_bytes=raw, segment_po2=PO2, trace=True)
    res = ex.run()
    if res.exit_code != 0 or res.journal != inp.block.hash():
        raise SystemExit("the guest did not validate the fixture block")
    log(f"[evm] block {os.path.basename(paths[0])[6:16]}: input "
        f"{len(raw)} bytes, {len(res.segments)} segments, "
        f"{res.user_cycles} user + {res.paging_cycles} paging cycles, "
        f"{res.keccak_calls} keccak / {res.bigint_calls} bigint / "
        f"{res.sha_calls} sha calls, journal = block hash, executed with "
        f"trace in {time.time() - t0:.1f} s")
    return res.segments[0], ia, iw, res, ex


def aux_challenges(air) -> np.ndarray:
    """The seeded challenges phase 7 builds the aux group under."""
    from zeth_tpu_torch.hostmath import P
    return np.random.default_rng(3).integers(
        1, P, size=(air.n_challenges, 4)).astype(np.uint64)


def host_aux_oracle(tmp: str) -> tuple:
    """Phase 7's oracle, run in a process of its own while phases 3-6
    run: EVM segment 0's aux group by the host ``build_aux`` under
    ``aux_challenges``, saved under `tmp` (so the ~0.9 GB result does not
    pass through the pool's pipe, whose reader shares the main process's
    interpreter). Returns (the .npy file of the (n, 108) standard-form
    aux, seconds of build_aux). Its front end prints nothing: phase 6
    prints it."""
    from zeth_tpu_torch.circuits import rv32im
    os.nice(10)
    with contextlib.redirect_stdout(io.StringIO()):
        seg, ia, iw, _, _ = evm_segment()
    air = rv32im.Rv32imAir(ia, iw)
    main, _ = air.witgen(seg, rv32im.choose_po2(seg, len(ia)))
    t0 = time.time()
    want = np.asarray(air.build_aux(main, aux_challenges(air)), np.uint64)
    host_s = time.time() - t0
    path = os.path.join(tmp, "aux_oracle.npy")
    np.save(path, want)
    return path, host_s


def check_aux(dev, card, seg, ia, iw, oracle) -> np.ndarray:
    """build_aux_device on the card against the host build_aux
    (``oracle``: the pending result of ``host_aux_oracle``), on the
    segment's main trace under seeded challenges, word for word. Returns
    that main trace (host, standard form)."""
    from zeth_tpu_torch import field as F
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.zkp import prover
    air = rv32im.Rv32imAir(ia, iw)
    po2 = rv32im.choose_po2(seg, len(ia))
    main, _ = air.witgen(seg, po2)
    chal = aux_challenges(air)
    path, host_s = oracle.get()
    want = np.load(path)
    os.remove(path)
    main_dev = prover._upload_std(main, dev)
    ctrl_dev = prover._upload_std(air.control_trace(po2), dev)
    air.build_aux_device(main_dev, ctrl_dev, chal)             # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    got_m = air.build_aux_device(main_dev, ctrl_dev, chal)
    torch.cuda.synchronize()
    dev_s = time.time() - t0
    extra = torch.cuda.max_memory_allocated(dev) - base
    got = F.from_monty(got_m).cpu().numpy().astype(np.uint64)
    if got.shape != want.shape:
        raise SystemExit(f"aux shape {got.shape}, expected {want.shape}")
    bad = np.nonzero((got != want).any(axis=0))[0]
    if bad.size:
        raise SystemExit(
            f"build_aux_device differs from the host build_aux first in "
            f"block {AUX_BLOCKS[bad[0] // 4]} (column {bad[0]}), "
            f"{bad.size} columns differ")
    filled = [b for k, b in enumerate(AUX_BLOCKS)
              if want[:, 4 * k:4 * k + 4].any()]
    # what build_aux_device's time is made of: its 17 per-row extension
    # inverses (a power p-2 on every row) and the six RLC chains' scan
    n = got_m.shape[0]
    x = got_m[:, :4].contiguous()
    _, inv_ms = cuda_ms(lambda: F.ext_inv(x), 3)
    act = (got_m[:, :6] & 1) * F.mont_one()
    val = got_m[:, :24].reshape(n, 6, 4).contiguous()
    one = F.to_monty(torch.tensor([1, 0, 0, 0], device=dev))
    _, scan_ms = cuda_ms(
        lambda: rv32im._dx_rlc_chain(act, val, val[1, 0], one), 2)
    log(f"{card} | [aux] ext_inv of ({n}, 4): {inv_ms:.3f} ms, 17 per build; "
        f"_dx_rlc_chain of ({n}, 6, 4): {scan_ms:.3f} ms, one per build")
    log(f"{card} | [aux] po2={po2}: build_aux_device equals the host "
        f"build_aux on all {want.shape[1]} columns x {want.shape[0]} rows "
        f"({len(filled)} of {len(AUX_BLOCKS)} blocks non-zero); device "
        f"{dev_s:.3f} s (+{extra / 2**30:.2f} GiB over the resident main "
        f"and control), host {host_s:.3f} s (in a process of its own)")
    del main_dev, ctrl_dev, got_m
    torch.cuda.empty_cache()
    return main


def require_launches(launches: dict, path: str, names=None) -> None:
    """Fail unless every kernel of `names` (default: all) was launched."""
    for name in names or launches:
        if launches[name] == 0:
            raise SystemExit(f"kernel {name} was not launched by the "
                             f"{path} path")


def staged_prove(card, tag, prove):
    """One prove with the prover's stage timers on; prints the table and
    the first stage whose end saw the prove's peak device memory."""
    from zeth_tpu_torch.zkp import prover
    prover.TIMING = True
    prover.STAGE_LOG.clear()
    prover.STAGE_PEAKS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = prove()
    torch.cuda.synchronize()
    total = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    prover.TIMING = False
    for name, dt in prover.STAGE_LOG:
        log(f"{card} | [{tag}] {name.strip()}: {dt:.3f} s")
    setter = next((name.strip() for name, b in prover.STAGE_PEAKS
                   if b == peak), "none")
    log(f"{card} | [{tag}] prove with stage timers: {total:.3f} s, peak "
        f"device memory {peak / 2**30:.2f} GiB, reached by the end of "
        f"'{setter}'")
    return out


def same_seals(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def main_streamed(on: bool):
    """Inside, with `on`, every main group that is not pre-committed is
    coset-streamed (``prover.STREAM_MAIN_BYTES`` = 0); restored after."""
    from zeth_tpu_torch.zkp import prover
    keep = prover.STREAM_MAIN_BYTES
    if on:
        prover.STREAM_MAIN_BYTES = 0
    try:
        yield
    finally:
        prover.STREAM_MAIN_BYTES = keep


@contextlib.contextmanager
def path_counters(dev):
    """The seconds (ending in a synchronise), leaf launches and peak
    device memory of what runs inside, in the dict it yields (and every
    kernel's launches as "counts", the leaf kernel's by (rows, cols) as
    "shapes"); the launch counts are set to 0 just before and read just
    after."""
    from zeth_tpu_torch import kernels
    got = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.time()
    yield got
    torch.cuda.synchronize()
    got["s"] = time.time() - t0
    got["counts"] = dict(kernels.LAUNCHES)
    got["shapes"] = dict(kernels.LAUNCH_SHAPES["poseidon2_leaf"])
    got["launches"] = got["counts"]["poseidon2_leaf"]
    got["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    got["rss_gib"] = host_rss_gib()


def fixture_batches(fx) -> dict:
    """The fixture's small accelerator batches, as prove_batch takes them
    (the same construction as tests/test_torch_accel_airs.py)."""
    k, b, h = fx["keccak"], fx["bigint"], fx["sha"]
    rng = np.random.default_rng(h["seed"])
    return {
        "keccak": (np.random.default_rng(k["seed"]).integers(
            0, 2**64, (k["nperm"], 25), dtype=np.uint64),),
        "bigint": ([tuple(op) for op in b["ops"]],),
        "sha": (rng.integers(0, 2**32, (h["nc"], 8), dtype=np.uint64),
                rng.integers(0, 2**32, (h["nc"], 16), dtype=np.uint64)),
    }


def check_claims_row(dev, card, limbs, digest) -> None:
    """The block's real bigint claims row through the leaf kernel's
    8-lane mapping (not the rule's: for one row that is the sponge
    kernel's own warp kernel) must hash to `digest`, the sponge kernel's
    (``sponge_row``). This launch compares the kernels and counts on no
    path."""
    from zeth_tpu_torch import hostmath as H
    from zeth_tpu_torch.hash import poseidon2 as P2
    row = H.to_monty_np(np.asarray(limbs, np.uint64)[None])
    t = torch.from_numpy(row.view(np.int32)).to(dev)
    leaf, ms = cuda_ms(lambda: P2._leaf_hash_lanes(t, 8), 1)
    got = H.from_monty_np(leaf.cpu().numpy().view(np.uint32))[0]
    if not np.array_equal(got, digest):
        raise SystemExit("the block's bigint claims row: poseidon2_leaf and "
                         "poseidon2_sponge (sponge_row) disagree")
    log(f"{card} | [accel] the block's bigint claims row ({t.shape[1]} "
        f"limbs): poseidon2_leaf on 8 lanes {ms:.3f} ms, the same digest as "
        "sponge_row's (poseidon2_sponge)")


def accel_phase(dev, card, ex, seg0_seal, fx) -> dict:
    """The block's accelerator batches proved and verified on the card,
    and linked to segment 0's bound IO. Returns each kernel's launches in
    the three proves."""
    from zeth_tpu_torch import kernels, zkvm
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.zkp import proof as proof_mod
    from zeth_tpu_torch.zkp import prover
    batches = zkvm.accelerator_batches(ex)
    if sorted(batches) != ["bigint", "keccak", "sha"]:
        raise SystemExit(f"the block made calls of {sorted(batches)} only")
    prover.TIMING = False
    out = {}
    launches = {name: 0 for name in kernels.NAMES}
    for kind, args in batches.items():
        mod = zkvm.accelerator_module(kind)
        with path_counters(dev) as got:
            seal, digest = staged_prove(
                card, f"{kind}-stage",
                lambda: mod.prove_batch(*args, device=dev))
        for name in launches:
            launches[name] += got["counts"][name]
        pf = proof_mod.decode(seal)
        out[kind] = (seal, digest)
        log(f"{card} | [accel] {kind}: {len(args[0])} calls, po2={pf.po2}, "
            f"{pf.openings['main'].rows.shape[1]} main / "
            f"{pf.openings['control'].rows.shape[1]} control columns, "
            f"{len(pf.publics)} publics, prove_batch {got['s']:.3f} s with "
            f"stage timers, peak device memory {got['peak_gib']:.2f} GiB, "
            f"peak host RSS {got['rss_gib']:.2f} GiB, "
            f"seal {seal.shape[0]} words ({seal.shape[0] * 4 / 2**20:.2f} "
            f"MiB)")
    require_launches(launches, "accel")
    log(f"{card} | [accel] launches of the three proves {launches}")
    words = {}
    for kind in batches:
        mod = zkvm.accelerator_module(kind)
        seal, digest = out[kind]
        t0 = time.time()
        io = mod.verify_batch(seal, dev)
        verify_s = time.time() - t0
        t0 = time.time()
        want = mod.claims_digest(io, dev)
        torch.cuda.synchronize()
        digest_s = time.time() - t0
        if not np.array_equal(want, digest):
            raise SystemExit(f"{kind}: prove_batch's claims digest differs "
                             "from the digest of the verified IO")
        if kind == "bigint":
            check_claims_row(dev, card, mod.claims_limbs(io), want)
        words[kind] = zkvm.accelerator_words(kind, io)
        log(f"{card} | [accel] {kind}: verify_batch {verify_s:.3f} s, "
            f"claims digest of the verified IO {digest_s:.3f} s, equal to "
            f"prove_batch's")
    # the resolve of the segment the card proved: its bound IO is a
    # prefix of the proof-bound streams
    pp = rv32im.parse_publics(proof_mod.decode(seg0_seal).publics)
    zkvm._check_accelerator_io(pp, words["keccak"], words["bigint"],
                               words["sha"])
    log(f"{card} | [accel] segment 0 binds {len(pp['keccak_words']) // 100} "
        f"keccak / {len(pp['bigint_words']) // 48} bigint / "
        f"{len(pp['sha_words']) // 32} sha calls: a prefix of the proof-bound "
        f"streams ({len(words['keccak']) // 100} / "
        f"{len(words['bigint']) // 48} / {len(words['sha']) // 32})")
    bad = out["keccak"][0].copy()
    bad[bad.shape[0] // 2] ^= 1
    try:
        zkvm._resolve_accelerators(zkvm.SegmentsInner(keccak_seal=bad), dev)
    except zkvm.VerificationError as e:
        log(f"[accel] keccak seal with one flipped word rejected: {e}")
    else:
        raise SystemExit("a keccak seal with a flipped word verified")
    for kind, args in fixture_batches(fx).items():
        seal, _ = zkvm.accelerator_module(kind).prove_batch(*args, device=dev)
        if sha(seal) != fx[kind]["seal_sha256"]:
            raise SystemExit(f"small {kind} seal differs from the fixture")
    log("[accel] small keccak, bigint and sha seals equal the fixture "
        "digests")
    return launches


def receipt_guests() -> list:
    """(name, elf, input, tamper, expected journal or None) of the
    receipt phase's guests."""
    from zeth_tpu_torch.executor import guests
    from zeth_tpu_torch.hash.keccak import permute_np
    from zeth_tpu_torch.hash.sha256 import IV, pad_message
    a, b, m = 1234567, 7654321, (1 << 31) - 1
    state = np.zeros((1, 25), np.uint64)
    for _ in range(2):
        state = permute_np(state)
    return [
        ("echo_input(16)", guests.echo_input(16), bytes(range(16)), "image",
         bytes(range(16))),
        ("keccak_guest(2)", guests.keccak_guest(2), b"", "keccak",
         state[0, :1].astype("<u8").tobytes()),
        ("bigint_guest(reps=2)", guests.bigint_guest(a, b, m, reps=2), b"",
         "bigint", (a * b % m * b % m).to_bytes(48, "little")),
        ("sha256_guest(abc)", guests.sha256_guest(
            [int(w) for w in IV], [int(w) for w in pad_message(b"abc")[0]]),
         b"", "sha", np.frombuffer(hashlib.sha256(b"abc").digest(), ">u4")
         .astype("<u4").tobytes()),
    ]


def receipt_phase(dev, card) -> dict:
    """LocalProver + Receipt.verify on the card for four guests, each with
    one tamper that must be rejected. Returns the phase's leaf launches."""
    from zeth_tpu_torch import kernels, zkvm
    from zeth_tpu_torch.executor import compute_image_id, guests
    kernels.reset_counts()
    for name, elf, inp, tamper, journal in receipt_guests():
        env = zkvm.ExecutorEnv.builder().write_slice(inp).build()
        t0 = time.time()
        info = zkvm.LocalProver(device=dev).prove(env, elf)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
        receipt = info.receipt
        if receipt.journal != journal:
            raise SystemExit(f"{name}: unexpected journal")
        image_id = compute_image_id(elf)
        t0 = time.time()
        receipt.verify(image_id, device=dev)
        verify_s = time.time() - t0
        if tamper == "image":
            image_id = compute_image_id(guests.echo_input(17))
        else:
            attr = f"{tamper}_seal"
            bad = getattr(receipt.inner, attr).copy()
            bad[bad.shape[0] // 2] ^= 1
            setattr(receipt.inner, attr, bad)
        try:
            receipt.verify(image_id, device=dev)
        except zkvm.VerificationError as e:
            why = str(e)
        else:
            raise SystemExit(f"{name}: a tampered receipt verified")
        log(f"{card} | [receipt] {name}: {info.stats.total_cycles} cycles, "
            f"{info.stats.segments} segment(s), prove {prove_s:.3f} s, "
            f"verify {verify_s:.3f} s, peak host RSS {host_rss_gib():.2f} "
            f"GiB; tampered {tamper} rejected: {why}")
    launches = dict(kernels.LAUNCHES)
    require_launches(launches, "receipt")
    return launches


def recursion_proof(dev, card, kind, what, prove) -> tuple:
    """One lift or join, as ``prove`` makes it, with the prover's stage
    timers on. Prints its program rows, recursion po2, the seconds of the
    host compile, the native interpreter, the control trace, the host
    LogUp aux and the prove, its leaf launches and the peak device
    memory (and, as ``prior_peak_gib``, the peak before it, whose counter
    it resets). Returns (RecReceipt, that row)."""
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.zkp import prover
    before = dict(kernels.LAUNCHES)
    prover.TIMING = True
    prover.STAGE_LOG.clear()
    torch.cuda.synchronize()
    prior = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    rec = prove()
    torch.cuda.synchronize()
    total = time.time() - t0
    prover.TIMING = False
    stages = {}
    for name, dt in prover.STAGE_LOG:
        stages[name.strip()] = stages.get(name.strip(), 0.0) + dt
    pr = rec.node.program
    row = {"kind": kind, "what": what, "rows": pr.n_rows, "po2": pr.po2(),
           "compile_s": stages.get("recursion compile (host)", 0.0),
           "witgen_s": stages["recursion witgen (host, native)"],
           "control_s": stages["control trace (host)"],
           "aux_s": stages["aux witgen (host)"],
           "prove_s": stages["recursion prove"], "total_s": total,
           "launches": kernels.LAUNCHES["poseidon2_leaf"]
           - before["poseidon2_leaf"],
           "sponge_launches": kernels.LAUNCHES["poseidon2_sponge"]
           - before["poseidon2_sponge"],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "prior_peak_gib": prior / 2**30, "rss_gib": host_rss_gib()}
    log(f"{card} | [succinct] {kind} {what}: {row['rows']} program rows, "
        f"recursion po2={row['po2']}; compile {row['compile_s']:.3f} s, "
        f"interpreter {row['witgen_s']:.3f} s, control trace "
        f"{row['control_s']:.3f} s, build_aux {row['aux_s']:.3f} s, prove "
        f"{row['prove_s']:.3f} s (the last three inside it), all "
        f"{total:.3f} s; {row['launches']} leaf and "
        f"{row['sponge_launches']} sponge launches, peak device "
        f"memory {row['peak_gib']:.2f} GiB, peak host RSS "
        f"{row['rss_gib']:.2f} GiB")
    return rec, row


def must_reject(what: str, check) -> str:
    """Run a verification that must fail; return why it failed."""
    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.zkp import verifier
    try:
        check()
    except (zkvm.VerificationError, verifier.VerificationError,
            ValueError, AssertionError) as e:
        log(f"[succinct] {what} rejected: {str(e)[:120]}")
        return str(e)
    raise SystemExit(f"{what} was accepted")


@contextlib.contextmanager
def timed_recursion(dev, card, rows: list):
    """Inside, every ``succinct.lift`` and ``succinct.join`` call, the
    library's own (``aggregate_segments`` and its fold call them by
    name), is one ``recursion_proof`` whose row is appended to
    ``rows``."""
    from zeth_tpu_torch.recursion import succinct
    lift, join = succinct.lift, succinct.join

    def timed_lift(inner_air, inner_proof, extra=None, device=None):
        what = (f"{inner_air.name.split(':')[0]} proof "
                f"(po2={inner_proof.po2}, "
                f"{len(inner_proof.publics)} publics)")
        rec, row = recursion_proof(
            dev, card, "lift", what,
            lambda: lift(inner_air, inner_proof, extra, device))
        row["air"] = inner_air.name
        row["receipt"] = rec
        rows.append(row)
        return rec

    def timed_join(left, right, device=None):
        what = (f"of recursion proofs at po2 {left.node.program.po2()} + "
                f"{right.node.program.po2()}")
        rec, row = recursion_proof(dev, card, "join", what,
                                   lambda: join(left, right, device))
        rows.append(row)
        return rec

    succinct.lift, succinct.join = timed_lift, timed_join
    try:
        yield
    finally:
        succinct.lift, succinct.join = lift, join


def succinct_main(dev, card, seal, pg_seal, ia, iw) -> list:
    """11a: EVM segment 0's proof and its paging proof lifted and joined
    to one root by ``succinct.aggregate_segments``, and the root verified
    by ``verify_root_segments`` on the card. The block's batches are not
    lifted (the keccak batch's lift alone is as large as the segment's):
    11b's receipt lifts one. Returns the per-proof rows."""
    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.circuits.paging import PagingAir
    from zeth_tpu_torch.circuits.rv32im import Rv32imAir
    from zeth_tpu_torch.hostmath import P
    from zeth_tpu_torch.recursion import succinct
    from zeth_tpu_torch.zkp import proof as proof_mod
    air, pg_air = Rv32imAir(ia, iw), PagingAir()
    proof, pg_proof = proof_mod.decode(seal), proof_mod.decode(pg_seal)
    extra = zkvm.paging_extras(pg_proof)
    rows = []
    t_start = time.time()
    with timed_recursion(dev, card, rows):
        root = succinct.aggregate_segments(
            air, [proof], pg_air, [pg_proof], [extra], device=dev)
    prove_s = time.time() - t_start
    # the segment's lift, its paging proof's and their join
    if len(rows) != 3:
        raise SystemExit(f"the fold made {len(rows)} recursion proofs, "
                         "expected 3")
    root_seal = proof_mod.encode(root.proof)

    pubs = [int(p) for p in proof.publics]
    pg_pubs = [int(p) for p in pg_proof.publics]

    def verify(rec, x):
        succinct.verify_root_segments(
            rec, air, [proof.po2], [pubs], [x], pg_air, [pg_proof.po2],
            [pg_pubs], [x[0]], device=dev)

    t0 = time.time()
    verify(succinct.RecReceipt(proof=proof_mod.decode(root_seal),
                               claim=root.claim, node=None), extra)
    verify_s = time.time() - t0
    log(f"{card} | [succinct] root: {len(rows)} recursion proofs in "
        f"{prove_s:.3f} s, root seal {root_seal.shape[0]} words "
        f"({root_seal.shape[0] * 4 / 1024:.1f} KiB), verify_root_segments "
        f"{verify_s:.3f} s (programs compiled, one control root "
        f"committed)")
    bad = root_seal.copy()
    bad[bad.shape[0] // 2] ^= 1

    def flipped():
        pf = proof_mod.decode(bad)
        verify(succinct.RecReceipt(proof=pf, claim=np.asarray(
            pf.publics, np.uint64), node=None), extra)

    must_reject("a root seal with one flipped word", flipped)
    forged = (extra[0], (np.asarray(extra[1], np.uint64) + np.uint64(1))
              % np.uint64(P), *extra[2:])
    must_reject("a d0 binding changed by one",
                lambda: verify(root, forged))
    return rows


def streamed_paging_lift(dev, card, resident_seal, pg_seal) -> dict:
    """11c: the paging proof's lift of 11a proved again with its main
    group coset-streamed (the recursion AIR's host aux, its program
    compiled already); the seal must equal 11a's `resident_seal` word for
    word. Returns its launches, counted around this run alone."""
    from zeth_tpu_torch.circuits.paging import PagingAir
    from zeth_tpu_torch.recursion import succinct
    from zeth_tpu_torch.zkp import proof as proof_mod
    with main_streamed(True), path_counters(dev) as got:
        streamed = succinct.lift(PagingAir(), proof_mod.decode(pg_seal),
                                 device=dev)
    if not np.array_equal(proof_mod.encode(streamed.proof), resident_seal):
        raise SystemExit("the streamed paging lift's seal differs from the "
                         "resident one")
    log(f"{card} | [streamed] paging lift (recursion po2="
        f"{streamed.proof.po2}) again with its main group coset-streamed: "
        f"the same seal word for word; {got['s']:.3f} s, {got['launches']} "
        f"leaf launches, peak device memory {got['peak_gib']:.2f} GiB, "
        f"peak host RSS {got['rss_gib']:.2f} GiB")
    return got["counts"]


def succinct_receipts(dev, card) -> None:
    """11b: ``LocalProver`` under ZETH_SUCCINCT=1 and ``Receipt.verify``
    on a bigint guest (one segment pair and the bigint batch lifted and
    folded), with the tampers of tools/succinct_e2e.py: a forged d0
    binding, a forged paging public, a flipped root-seal word and a
    flipped accelerator public."""
    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.executor import compute_image_id, guests
    from zeth_tpu_torch.hostmath import P
    saved = os.environ.get("ZETH_SUCCINCT")
    os.environ["ZETH_SUCCINCT"] = "1"
    try:
        a, b, m, reps, po2 = 1234567, 7654321, (1 << 31) - 1, 2, 20
        name = f"bigint_guest(reps={reps})"
        elf = guests.bigint_guest(a, b, m, reps=reps)
        env = zkvm.ExecutorEnv.builder().segment_limit_po2(po2).build()
        t0 = time.time()
        with timed_recursion(dev, card, []):
            info = zkvm.LocalProver(device=dev).prove(env, elf)
        torch.cuda.synchronize()
        prove_s = time.time() - t0
        receipt, inner = info.receipt, info.receipt.inner
        image_id = compute_image_id(elf)
        if inner.kind != "succinct":
            raise SystemExit(f"{name}: a {inner.kind} receipt")
        t0 = time.time()
        receipt.verify(image_id, device=dev)
        verify_s = time.time() - t0
        n_seg = len(inner.segment_publics)
        log(f"{card} | [succinct] receipt {name}: "
            f"{info.stats.total_cycles} cycles, {n_seg} segment(s) at "
            f"po2 {inner.segment_po2s}, accelerator claims "
            f"{[k for k, _, _ in inner.accel_publics]}, prove "
            f"{prove_s:.3f} s, root seal {inner.root_seal.shape[0]} "
            f"words, verify {verify_s:.3f} s")
        if receipt.journal != (a * pow(b, reps, m) % m).to_bytes(
                48, "little"):
            raise SystemExit(f"{name}: unexpected journal")
        if not inner.accel_publics:
            raise SystemExit(f"{name}: no accelerator claim lifted")

        def reject(what, mutate):
            keep = mutate()
            must_reject(f"{name}: {what}",
                        lambda: receipt.verify(image_id, device=dev))
            keep()

        def d0():
            x = inner.segment_extras[0]
            inner.segment_extras[0] = (
                x[0], (np.asarray(x[1], np.uint64) + np.uint64(1))
                % np.uint64(P), *x[2:])
            return lambda: inner.segment_extras.__setitem__(0, x)

        def paging():
            mid = n_seg // 2
            keep = inner.paging_publics[mid]
            inner.paging_publics[mid] = list(keep)
            inner.paging_publics[mid][32] ^= 1
            return lambda: inner.paging_publics.__setitem__(mid, keep)

        def root_word():
            keep = inner.root_seal
            inner.root_seal = keep.copy()
            inner.root_seal[keep.shape[0] // 2] ^= 1
            return lambda: setattr(inner, "root_seal", keep)

        def accel_pub():
            keep = inner.accel_publics[0]
            pubs = list(keep[2])
            pubs[1] ^= 1
            inner.accel_publics[0] = (keep[0], keep[1], pubs)
            return lambda: inner.accel_publics.__setitem__(0, keep)

        reject("a forged d0 binding", d0)
        reject(f"a forged paging public (limb 32) of segment {n_seg // 2}",
               paging)
        reject("a flipped root-seal word", root_word)
        reject("a flipped accelerator public", accel_pub)
        # the tampers were undone: the receipt verifies again
        receipt.verify(image_id, device=dev)
    finally:
        if saved is None:
            os.environ.pop("ZETH_SUCCINCT", None)
        else:
            os.environ["ZETH_SUCCINCT"] = saved


@contextlib.contextmanager
def timed_cli(rows: dict):
    """Inside, ``BlockProcessor.prove`` and ``Receipt.verify`` are the
    library's own, timed: the receipt the CLI proved and the seconds of
    each call go into ``rows``, so the block is proved once."""
    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.app import host
    prove, verify = host.BlockProcessor.prove, zkvm.Receipt.verify

    def timed_prove(proc, inp, segment_po2=None, device=None):
        torch.cuda.synchronize()
        t0 = time.time()
        receipt = prove(proc, inp, segment_po2, device)
        torch.cuda.synchronize()
        rows["prove_s"] = time.time() - t0
        rows["receipt"] = receipt
        return receipt

    def timed_verify(receipt, image_id, device=None):
        t0 = time.time()
        verify(receipt, image_id, device)
        rows["verify_s"] = time.time() - t0

    host.BlockProcessor.prove, zkvm.Receipt.verify = timed_prove, timed_verify
    try:
        yield
    finally:
        host.BlockProcessor.prove, zkvm.Receipt.verify = prove, verify


def receipt_po2s(inner) -> tuple:
    """(segment po2s, {batch kind: po2}) of a segments or succinct
    receipt."""
    from zeth_tpu_torch.zkp import proof as proof_mod
    if hasattr(inner, "root_seal"):
        return (list(inner.segment_po2s),
                {kind: po2 for kind, po2, _ in inner.accel_publics})
    seals = {k: getattr(inner, f"{k}_seal") for k in ("keccak", "bigint",
                                                       "sha")}
    return ([proof_mod.decode(s).po2 for s in inner.seals],
            {k: proof_mod.decode(s).po2 for k, s in seals.items()
             if s is not None})


def run_cli(argv: list) -> tuple:
    """(exit code, standard output) of the port's CLI, echoed."""
    from zeth_tpu_torch.app import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    for line in buf.getvalue().splitlines():
        log(f"[cli] > {line}")
    return rc, buf.getvalue()


def cli_validate(tmp: str) -> tuple:
    """Phase 12's ``cli validate`` of the smaller fixture block, host
    only, at the block's full size, run in a process of its own while
    phases 3-11 run: (block file, block number, seconds to build and load
    the native engine, exit code, standard output, seconds)."""
    from zeth_tpu_torch.app import evm
    from zeth_tpu_torch.app.host import StatelessInput
    os.nice(10)
    # the native engine, built from the checkout by make, outside the timer
    t0 = time.time()
    evm.get_lib()
    build_s = time.time() - t0
    path = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures",
                                         "input_0x*.json")),
                  key=os.path.getsize)[0]
    with open(path) as f:
        number = StatelessInput.from_json(json.load(f)).block.number
    vdir = os.path.join(tmp, "validate")
    os.makedirs(vdir)
    shutil.copy(path, vdir)
    from zeth_tpu_torch.app import cli
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--cache-dir", vdir, "--block", str(number),
                       "validate"])
    return path, number, build_s, rc, buf.getvalue(), time.time() - t0


def cli_phase(dev, card, tmp: str, validated) -> dict:
    """12: ``cli validate`` of the smaller fixture block (`validated`: the
    pending result of ``cli_validate``), then ``cli prove`` of block 101
    on the card, with two tampers. Returns the leaf launches of the prove
    run."""
    from zeth_tpu_torch import kernels, zkvm
    from zeth_tpu_torch.app.host import BlockProcessor
    from zeth_tpu_torch.zkp import prover
    # (a) validate
    path, number, build_s, rc, out, validate_s = validated.get()
    log(f"[cli] native EVM engine (zeth_tpu_torch/app/csrc/evm.cpp) built "
        f"and loaded in {build_s:.1f} s")
    for line in out.splitlines():
        log(f"[cli] > {line}")
    want = os.path.basename(path)[len("input_"):-len(".json")]
    if rc != 0 or f"hash {want}" not in out:
        raise SystemExit(f"cli validate of block {number} returned {rc}, "
                         f"expected 0 and the hash {want[:18]}...")
    log(f"{card} | [cli] validate block {number} ({want[:18]}...): exit 0, "
        f"hash equals the file's name, {validate_s:.3f} s on the host's "
        f"native EVM engine (in a process of its own)")
    # (b) prove on the card, as a user runs it
    if os.environ.get("ZETH_DEV_MODE") is not None:
        raise SystemExit("ZETH_DEV_MODE is set: cli prove would not prove")
    pdir = os.path.join(tmp, "prove")
    os.makedirs(pdir)
    for p in glob.glob(os.path.join(ROOT, "tests", "fixtures", "cli",
                                    "input_0x*.json")):
        shutil.copy(p, pdir)
    rows = {}
    prover.TIMING = False
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.time()
    with timed_cli(rows):
        rc, out = run_cli(["--cache-dir", pdir, "--block", "101", "prove"])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    if rc != 0 or "receipt verified; journal matches block hash" not in out:
        raise SystemExit(f"cli prove of block 101 returned {rc}")
    require_launches(launches, "cli")
    receipt, st = rows["receipt"], rows["receipt"].stats
    inner = receipt.inner
    if inner.kind != "segments" or inner.keccak_seal is None:
        raise SystemExit("cli prove gave no segments receipt with a keccak "
                         "seal")
    po2s, batches = receipt_po2s(inner)
    log(f"{card} | [cli] prove block 101 at --segment-po2 20: exit 0, "
        f"prove {rows['prove_s']:.3f} s, verify {rows['verify_s']:.3f} s, "
        f"cli all {cli_s:.3f} s; {st.segments} segment(s) at po2 {po2s}, "
        f"{st.user_cycles} user + {st.paging_cycles} paging cycles, "
        f"{st.keccak_calls} keccak calls, batches (po2) {batches}; "
        f"{launches['poseidon2_leaf']} leaf launches, peak device memory "
        f"{peak / 2**30:.2f} GiB, peak host RSS {host_rss_gib():.2f} GiB")
    image_id = BlockProcessor.for_chain_id(1).image_id()
    for what, attr in (("segment seal", "seals"),
                       ("keccak seal", "keccak_seal")):
        keep = getattr(inner, attr)
        bad = (keep[0] if attr == "seals" else keep).copy()
        bad[bad.shape[0] // 2] ^= 1
        setattr(inner, attr, [bad] + keep[1:] if attr == "seals" else bad)
        try:
            receipt.verify(image_id, device=dev)
        except zkvm.VerificationError as e:
            log(f"[cli] a flipped {what} word rejected: {str(e)[:120]}")
        else:
            raise SystemExit(f"a receipt with a flipped {what} word verified")
        finally:
            setattr(inner, attr, keep)
    return launches


def mesh_rank(mesh, spin_iters: int, segment_po2: int,
              compare_lde: bool) -> dict:
    """One rank of phase 13, in a process of its own: the spin segment of
    `spin_iters` executed, then proved by ``prove_segments(mesh=...)``
    with this rank's shards on its card; its seals, seconds, leaf
    launches (counted from 0 around the prove), peak device memory, the
    collectives' calls, bytes and seconds, and their transport. With
    `compare_lde`, then the main group's sharded LDE and commit timed
    alone (``prover._lde(mesh=...)``, ``merkle.commit_rows_sharded``)."""
    import torch.distributed as dist
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.convert import resolve_device
    from zeth_tpu_torch.hash import merkle
    from zeth_tpu_torch.parallel import comm
    from zeth_tpu_torch.zkp import prover
    dev = resolve_device(None, mesh)
    # a spawned process starts from its parent's peak (Linux keeps it
    # across exec): the rank's own peak shows only where it passes this
    rss_start = host_rss_gib()
    seg, ia, iw, _, _ = spin_segment(spin_iters, segment_po2)
    kernels.load("poseidon2_leaf")
    comm.reset_stats()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()
    kernels.reset_counts()
    t0 = time.time()
    seals, pg_seals = rv32im.prove_segments([seg], ia, iw, mesh=mesh)
    torch.cuda.synchronize(dev)
    out = {"rank": comm.rank(mesh), "device": str(dev),
           "s": time.time() - t0, "seals": (seals[0], pg_seals[0]),
           "counts": dict(kernels.LAUNCHES),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "rss_gib": host_rss_gib(), "rss_start_gib": rss_start,
           "comm": dict(comm.STATS),
           "transport": comm.transport(mesh, dev)}
    if compare_lde:
        air = rv32im.Rv32imAir(ia, iw)
        main, _ = air.witgen(seg, rv32im.choose_po2(seg, len(ia)))
        rows = main.shape[0] // comm.size(mesh)
        lo = comm.rank(mesh) * rows
        block = prover._upload_main(air, main[lo:lo + rows], dev)
        comm.reset_stats()
        torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.time()
        lde = prover._lde(block, std=True, mesh=mesh)
        torch.cuda.synchronize(dev)
        t1 = time.time()
        tree = merkle.commit_rows_sharded(lde, mesh)
        torch.cuda.synchronize(dev)
        out["lde"] = {"shape": (main.shape[0], main.shape[1]),
                      "lde_s": t1 - t0, "commit_s": time.time() - t1,
                      "root": tree.root, "comm": dict(comm.STATS)}
    return out


def mesh_lines(card, tag: str, ranks: list) -> None:
    for r in ranks:
        comm_s = ", ".join(f"{op} {c} calls {b / 2**20:.2f} MiB {t:.3f} s"
                           for op, (c, b, t) in sorted(r["comm"].items()))
        log(f"{card} | [mesh] {tag} rank {r['rank']} on {r['device']}: "
            f"prove_segments {r['s']:.3f} s, {r['counts']['poseidon2_leaf']} "
            f"leaf launches, peak device memory {r['peak_gib']:.2f} GiB, "
            f"peak host RSS {r['rss_gib']:.2f} GiB (inherited "
            f"{r['rss_start_gib']:.2f} GiB at its start); "
            f"collectives ({r['transport']}): {comm_s}")


def mesh_phase(dev, card, fx, spin, spin_seals) -> dict:
    """13: (a) MESH_FIXTURE_RANKS ranks on the card prove phase 4's
    fixture spin segment with ``prove_segments(mesh=...)``: the seals
    must hash to the fixture digests; (b) MESH_SPIN_RANKS ranks prove
    phase 5's spin segment: the seals must equal phase 5's word for word
    and verify, and the main group's sharded LDE and commit are timed
    against the unsharded ``_lde`` + ``commit_rows`` at the same shape
    (same root). Every rank's seals must equal every other rank's.
    Returns the leaf launches of both runs' proves, summed over ranks."""
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.hash import merkle
    from zeth_tpu_torch.parallel import multihost
    from zeth_tpu_torch.zkp import prover
    launches = {name: 0 for name in kernels.NAMES}
    seg, ia, iw, entry, claim = spin
    runs = (("a", MESH_FIXTURE_RANKS, fx["spin_iters"], fx["segment_po2"]),
            ("b", MESH_SPIN_RANKS, ((1 << SPIN_PO2) - 4096) * 3 // 2,
             SPIN_PO2))
    for tag, d, iters, seg_po2 in runs:
        t0 = time.time()
        ranks = multihost.launch(mesh_rank, d, iters, seg_po2, tag == "b",
                                 threads=max(1, 8 // d), timeout=600)
        wall = time.time() - t0
        mesh_lines(card, f"({tag}) D={d}", ranks)
        for r in ranks[1:]:
            if not same_seals(r["seals"], ranks[0]["seals"]):
                raise SystemExit(f"mesh ({tag}): rank {r['rank']}'s seals "
                                 "differ from rank 0's")
        got = ranks[0]["seals"]
        if tag == "a":
            if (sha(got[0]), sha(got[1])) != (fx["seal_sha256"],
                                              fx["paging_sha256"]):
                raise SystemExit("mesh (a): the sharded seals differ from "
                                 "the fixture digests")
            what = "equal the fixture digests"
        else:
            if not same_seals(got, spin_seals):
                raise SystemExit("mesh (b): the sharded seals differ from "
                                 "phase 5's")
            t1 = time.time()
            rv32im.verify_segments([got[0]], [got[1]], claim, ia, iw, entry,
                                   device=dev)
            what = (f"equal phase 5's word for word, verify_segments "
                    f"{time.time() - t1:.3f} s")
        for r in ranks:
            for name in launches:
                launches[name] += r["counts"][name]
        require_launches({n: sum(r["counts"][n] for r in ranks)
                          for n in launches}, f"mesh ({tag})", LEAF_ONLY)
        log(f"{card} | [mesh] ({tag}) spin({iters}) po2="
            f"{rv32im.choose_po2(seg, len(ia)) if tag == 'b' else fx['po2']} "
            f"over D={d} ranks on one card: every rank's seals equal, "
            f"{what}; slowest rank {max(r['s'] for r in ranks):.3f} s, "
            f"launch with rank start-up {wall:.3f} s")
    # (b)'s main group: sharded LDE + commit against the unsharded ones
    sh = [r["lde"] for r in ranks]
    air = rv32im.Rv32imAir(ia, iw)
    main, _ = air.witgen(seg, rv32im.choose_po2(seg, len(ia)))
    block = prover._upload_main(air, main, dev)
    torch.cuda.synchronize()
    t0 = time.time()
    lde = prover._lde(block, std=True)
    torch.cuda.synchronize()
    t1 = time.time()
    tree = merkle.commit_rows(lde)
    torch.cuda.synchronize()
    lde_s, commit_s = t1 - t0, time.time() - t1
    if any(not np.array_equal(x["root"], tree.root) for x in sh):
        raise SystemExit("mesh (b): the sharded main root differs from the "
                         "unsharded one")
    for r, x in zip(ranks, sh):
        moved = ", ".join(f"{op} {c} calls {b / 2**20:.2f} MiB {t:.3f} s"
                          for op, (c, b, t) in sorted(x["comm"].items()))
        log(f"{card} | [mesh] (b) main group {x['shape']} rank {r['rank']}: "
            f"sharded LDE {x['lde_s']:.3f} s + commit {x['commit_s']:.3f} s "
            f"({moved}); unsharded _lde {lde_s:.3f} s + commit_rows "
            f"{commit_s:.3f} s; same root")
    del block, lde, tree
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on a GPU only")
    dev = torch.device("cuda", 0)
    from zeth_tpu_torch import kernels
    t_start = time.time()

    # 1. device
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    malloc_check()

    # 2. build
    t0 = time.time()
    logs = kernels.build_all(force=True)
    for name, out in logs.items():
        log(f"[build] {name}: {out.strip()}")
    log(f"[build] {len(logs)} kernel(s) in {time.time() - t0:.1f} s")

    # two host-only jobs, phase 7's aux oracle and phase 12's validate,
    # run in processes of their own from here on; leaving the block
    # stops them
    with tempfile.TemporaryDirectory() as tmp, \
            multiprocessing.get_context("spawn").Pool(2) as pool:
        run_phases(dev, card, t_start, tmp,
                   pool.apply_async(host_aux_oracle, (tmp,)),
                   pool.apply_async(cli_validate, (tmp,)))


def run_phases(dev, card, t_start: float, tmp: str, oracle,
               validated) -> None:
    """Phases 3-14 (`oracle` and `validated`: the pending results of
    ``host_aux_oracle`` and ``cli_validate``)."""
    from zeth_tpu_torch import kernels, ntt
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.circuits.paging import PagingAir
    from zeth_tpu_torch.hostmath import P
    from zeth_tpu_torch.zkp import proof as proof_mod
    last = [time.time()]

    def mark(n: int, what: str) -> None:
        """Each phase's seconds, also on standard error: where a run is
        stopped at its time limit, the phases that ended are shown."""
        now = time.time()
        msg = (f"[phase {n}] {what}: {now - last[0]:.1f} s, "
               f"{now - t_start:.1f} s from the start")
        last[0] = now
        log(msg)
        print(msg, file=sys.stderr, flush=True)

    # 3. kernels against their plain versions, then the int8 field
    # products against the radix-2 and the coset recompute
    results = check_poseidon2_kernels(dev, card, P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    check_four_step(dev, card, P, gen, FS_SHAPES)
    check_eval_rows(dev, card, P, gen)
    # the device tables those checks cached (the 2^24-row coset power
    # tables alone hold ~0.8 GiB) would count in every later peak
    ntt._TABLES.clear()
    torch.cuda.empty_cache()
    mark(3, "kernels")

    # 4. the small-po2 oracle
    with open(FIXTURE) as f:
        fixture = json.load(f)
    fx = fixture["spin"]
    seg, ia, iw, _, _ = spin_segment(fx["spin_iters"], fx["segment_po2"])
    streamed_runs = {}
    for streamed in (False, True):
        how = "coset-streamed" if streamed else "resident"
        with main_streamed(streamed), path_counters(dev) as got:
            seal, pg_seal = rv32im.prove_segment(seg, ia, iw, device=dev)
        if (sha(seal), sha(pg_seal)) != (fx["seal_sha256"],
                                         fx["paging_sha256"]):
            raise SystemExit(f"small-po2 seals ({how} main group) differ "
                             "from the fixture digests")
        log(f"{card} | [oracle] spin({fx['spin_iters']}) po2={fx['po2']}, "
            f"main group {how}: seal and paging seal equal the fixture "
            f"digests; "
            f"{got['s']:.3f} s, {got['launches']} leaf launches, peak "
            f"device memory {got['peak_gib']:.3f} GiB, peak host RSS "
            f"{got['rss_gib']:.3f} GiB")
        if streamed:
            streamed_runs["spin"] = got["counts"]
    mark(4, "oracle")

    # 5. the spin path: one halting segment (bench.py's guest sizing) at
    # SPIN_PO2, proved once, as a user calls it, with the prover's stage
    # timers on (the breakdown), and verified as bench.py verifies it
    seg, ia, iw, entry, claim = spin_segment(
        ((1 << SPIN_PO2) - 4096) * 3 // 2, SPIN_PO2)
    cycles = int(seg.trace.shape[0])
    with path_counters(dev) as got:
        seal, pg_seal = staged_prove(
            card, "spin-stage",
            lambda: rv32im.prove_segment(seg, ia, iw, device=dev))
    prove_s, spin_launches = got["s"], got["counts"]
    require_launches(spin_launches, "spin", LEAF_ONLY)
    t0 = time.time()
    rv32im.verify_segments([seal], [pg_seal], claim, ia, iw, entry,
                           device=dev)
    verify_s = time.time() - t0
    log(f"{card} | [spin] po2={SPIN_PO2}: {cycles} cycles, prove_segment "
        f"{prove_s:.3f} s with stage timers "
        f"({cycles / prove_s / 1e6:.4f} Mcycles/s), verify_segments "
        f"{verify_s:.3f} s (both STARKs and the chain checks), peak device "
        f"memory {got['peak_gib']:.2f} GiB, peak host RSS "
        f"{got['rss_gib']:.2f} GiB, launches {spin_launches}")
    # phase 13 proves this segment again over several ranks
    spin, spin_seals = (seg, ia, iw, entry, claim), (seal, pg_seal)
    del seg
    torch.cuda.empty_cache()
    mark(5, "spin")

    # 6. the EVM segment's front end
    seg, ia, iw, res, ex = evm_segment()
    cycles = int(seg.trace.shape[0])
    del res
    mark(6, "EVM front end")

    # 7. the aux group on the card against the host oracle
    main_trace = check_aux(dev, card, seg, ia, iw, oracle)
    mark(7, "aux")

    # 8. the EVM path, full width and depth, with the stage timers on:
    # the launch counts and peak memory read around it
    with path_counters(dev) as got:
        seals, pg_seals = staged_prove(
            card, "evm-stage",
            lambda: rv32im.prove_segments([seg], ia, iw, device=dev))
    prove_s, peak, launches = got["s"], got["peak_gib"], got["counts"]
    evm_rss = got["rss_gib"]
    evm_shapes = got["shapes"]
    require_launches(launches, "EVM", LEAF_ONLY)
    del seg
    torch.cuda.empty_cache()
    check_upload(dev, card, rv32im.Rv32imAir(ia, iw), main_trace)
    del main_trace
    pg_s, rv_s = verify_pair(dev, seals[0], pg_seals[0], ia, iw)
    words = seals[0].shape[0] + pg_seals[0].shape[0]
    log(f"{card} | [evm] po2={PO2}: segment 0, {cycles} cycles, "
        f"prove_segments {prove_s:.3f} s with stage timers "
        f"({cycles / prove_s / 1e6:.4f} Mcycles/s), verify {pg_s:.3f} s "
        f"paging + {rv_s:.3f} s rv32im, seal {seals[0].shape[0]} + paging "
        f"{pg_seals[0].shape[0]} words ({words * 4 / 1024:.1f} KiB), "
        f"peak device memory {peak:.2f} GiB, peak host RSS {evm_rss:.2f} "
        f"GiB, launches {launches}")

    # the leaf kernel's share of the segment: each shape the prove
    # launched it on, timed once on random data
    evm_leaf_ms = leaf_time_by_shape(dev, card, P, gen, "evm", evm_shapes)
    mark(8, "EVM")

    # 9. the block's accelerator batches, and the resolve of segment 0
    accel_launches = accel_phase(dev, card, ex, seals[0], fixture)
    del ex
    torch.cuda.empty_cache()
    mark(9, "accel")

    # 10. receipts through the zkvm API
    receipt_launches = receipt_phase(dev, card)
    mark(10, "receipt")

    # 11. the recursion: segment 0 and its paging proof folded to one
    # root proof, then a succinct receipt
    kernels.reset_counts()
    rec_rows = succinct_main(dev, card, seals[0], pg_seals[0], ia, iw)
    pg_lift_seal = proof_mod.encode(next(
        r["receipt"] for r in rec_rows
        if r.get("air") == PagingAir().name).proof)
    pg_seal0 = pg_seals[0]
    del seals, pg_seals, rec_rows
    torch.cuda.empty_cache()
    mark(11, "succinct (a)")
    succinct_receipts(dev, card)
    succinct_launches = dict(kernels.LAUNCHES)
    succinct_shapes = dict(kernels.LAUNCH_SHAPES["poseidon2_leaf"])
    require_launches(succinct_launches, "succinct")
    log(f"{card} | [succinct] leaf launches by (rows, cols): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(succinct_shapes.items())))
    # the streamed path's second run, counted alone like phase 4's
    streamed_runs["paging lift"] = streamed_paging_lift(
        dev, card, pg_lift_seal, pg_seal0)
    del pg_seal0
    # phase 4's spin segment hashes no digest; the lift's claim does
    for what, counts in streamed_runs.items():
        require_launches(counts, f"streamed {what}",
                         LEAF_ONLY if what == "spin" else None)
    streamed_launches = {name: sum(c[name] for c in streamed_runs.values())
                         for name in kernels.NAMES}
    log(f"{card} | [streamed] launches of the streamed runs "
        f"{streamed_runs}")
    torch.cuda.empty_cache()
    mark(11, "succinct (b) and (c)")

    # 12. the CLI: validate a fixture block, prove block 101 on the card
    cli_launches = cli_phase(dev, card, tmp, validated)
    torch.cuda.empty_cache()
    mark(12, "cli")

    # 13. the multi-device path: several ranks on the one card
    mesh_launches = mesh_phase(dev, card, fx, spin, spin_seals)
    mark(13, "mesh")

    # 14. results
    log(f"[done] {time.time() - t_start:.1f} s")
    by_path = {name: {"spin": spin_launches[name], "evm": launches[name],
                      "accel": accel_launches[name],
                      "receipt": receipt_launches[name],
                      "succinct": succinct_launches[name],
                      "cli": cli_launches[name],
                      "streamed": streamed_launches[name],
                      "mesh": mesh_launches[name]}
               for name in kernels.NAMES}
    results["poseidon2_leaf"]["launches_by_shape"] = {
        path: [[r, c, n] for (r, c), n in sorted(shapes.items())]
        for path, shapes in (("evm", evm_shapes),
                             ("succinct", succinct_shapes))}
    results["poseidon2_leaf"]["evm_leaf_ms"] = evm_leaf_ms
    print(json.dumps({"kernels": [
        dict(name=name, **KERNELS[name],
             launches=by_path[name][KERNELS[name]["main_path"]],
             launches_by_path=by_path[name], **results[name])
        for name in kernels.NAMES]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
