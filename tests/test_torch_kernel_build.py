"""The CUDA kernels' sources and builds, without nvcc.

Both kernels include ``kernels/csrc/poseidon2.cuh``, so a library must be
rebuilt when that header (or any file under ``csrc/`` its source
includes) is newer than it: ``kernels._stale`` is held to that on
temporary directories with touched files. The sources must define the
field arithmetic once, in the header. The leaf kernel's wrappers take
the plain ``hash_rows`` on a CPU tensor, count nothing there, and refuse
a mapping the kernel does not have.
"""

import os
import re

import numpy as np
import pytest
import torch

from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch import kernels
from zeth_tpu_torch.hash import poseidon2 as TP2


def _write(path, mtime, text=""):
    with open(path, "w") as f:
        f.write(text)
    os.utime(path, (mtime, mtime))


def test_stale_sees_the_headers_a_source_includes(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD", str(build))
    _write(csrc / "k.cu", 100, '#include <cstdint>\n#include "a.cuh"\n')
    _write(csrc / "a.cuh", 100, '#pragma once\n  #  include "b.cuh"\n')
    _write(csrc / "b.cuh", 100)
    _write(csrc / "other.cuh", 500)
    assert kernels._stale("k")                       # no library yet
    _write(build / "libk.so", 200)
    assert not kernels._stale("k")                   # other.cuh is not included
    os.utime(csrc / "b.cuh", (300, 300))
    assert kernels._stale("k")                       # included through a.cuh
    _write(build / "libk.so", 400)
    assert not kernels._stale("k")
    os.utime(csrc / "k.cu", (450, 450))
    assert kernels._stale("k")


def test_both_kernels_share_one_copy_of_the_arithmetic():
    header = os.path.join(kernels.CSRC, "poseidon2.cuh")
    for name in kernels.NAMES:
        src = os.path.join(kernels.CSRC, f"{name}.cu")
        assert kernels._sources(src) == {src, header}
    defs = re.compile(r"uint32_t\s+(add|mul|sbox|warp_sum)\s*\(")
    where = {}
    for path in sorted(os.listdir(kernels.CSRC)):
        with open(os.path.join(kernels.CSRC, path)) as f:
            for fn in defs.findall(f.read()):
                where.setdefault(fn, []).append(path)
    assert where == {fn: ["poseidon2.cuh"]
                     for fn in ("add", "mul", "sbox", "warp_sum")}


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_leaf_hash_lanes_on_cpu_is_the_plain_sponge(lanes):
    rows = torch.from_numpy(np.random.default_rng(42).integers(
        0, H.P, (9, 33), dtype=np.uint32).view(np.int32))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(TP2._leaf_hash_lanes(rows, lanes),
                       TP2.hash_rows(rows))
    assert torch.equal(TP2.leaf_hash(rows), TP2.hash_rows(rows))
    assert kernels.LAUNCHES == before


def test_leaf_hash_lanes_refuses_other_mappings():
    with pytest.raises(ValueError, match="lanes a row"):
        TP2._leaf_hash_lanes(torch.zeros((2, 4), dtype=torch.int32), 4)


def test_counts_by_shape_reset_with_the_launches():
    kernels.reset_counts()
    kernels.count("poseidon2_leaf", 4, 9)
    kernels.count("poseidon2_leaf", 4, 9)
    kernels.count("poseidon2_sponge", 1, 70)
    assert kernels.LAUNCHES == {"poseidon2_leaf": 2, "poseidon2_sponge": 1}
    assert kernels.LAUNCH_SHAPES == {"poseidon2_leaf": {(4, 9): 2},
                                     "poseidon2_sponge": {(1, 70): 1}}
    kernels.reset_counts()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.NAMES}
    assert all(not c for c in kernels.LAUNCH_SHAPES.values())


# a made-up cuobjdump listing: a chunk loop (0x0010-0x00d0) holding three
# rolled round loops (ROUND_TRIPS: 4, 21 and 4 trips) and an unconditional
# forward branch over the ragged tail's absorb (0x00a0)
_SASS = """
        Function : _ZN12_GLOBAL__N_110row_kernelEPKjPjll
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0020*/                   IADD3 R6, R2, R3, RZ ;
        /*0030*/                   IMAD.HI.U32 R7, R6, R6, RZ ;
        /*0040*/               @P0 BRA 0x30 ;
        /*0050*/                   VIADDMNMX.U32 R7, R7, 0x87ffffff, R7, PT ;
        /*0060*/               @P0 BRA 0x50 ;
        /*0070*/                   IMAD.MOV R6, RZ, RZ, -R7 ;
        /*0080*/              @!P0 BRA 0x70 ;
        /*0090*/                   BRA 0xb0 ;
        /*00a0*/                   LDG.E.CONSTANT R8, desc[UR4][R10.64] ;
        /*00b0*/                   IMAD.IADD R9, R9, 0x1, R8 ;
        /*00c0*/                   ISETP.NE.AND P1, PT, R9, RZ, PT ;
        /*00d0*/               @P1 BRA 0x10 ;
        /*00e0*/                   EXIT ;
"""


def test_sass_counts_of_a_chunk_loop_by_pipe():
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(kernels.CSRC), "..",
                                    "..", "tools"))
    import torch_leaf_turns as T
    assert T.ROUND_TRIPS == (4, 21, 4)
    got = T.sass_counts(_SASS)["row_kernel"]
    # once a pass: IMAD.WIDE, IADD3, BRA 0xb0, IMAD.IADD, ISETP, BRA 0x10;
    # each round loop's two instructions once a trip; the tail's LDG is
    # jumped over
    assert got["pass"] == 6 + 2 * (4 + 21 + 4)
    assert got["fma"] == 2 + 4 + 4                   # WIDE, IADD; HI; MOV
    assert got["fma_cycles"] == 2 + 1 + 2 * 4 + 4
    assert got["alu"] == 2 + 21                      # IADD3, ISETP; VIADDMNMX
    assert got["other"] == 2 + 4 + 21 + 4            # the branches
    assert got["ops"]["VIADDMNMX.U32"] == 21
    assert "LDG.E.CONSTANT" not in got["ops"]
    assert got["code_bytes"] == 0xf0
    assert [T.pipe_of(op) for op in ("@!P2 IMAD.MOV R1, RZ, RZ, -R2",
                                     "LOP3.LUT R1, R2, R3, RZ, 0xc0, !PT",
                                     "SHFL.BFLY PT, R1, R2, 0x1, 0x1f")] \
        == ["fma", "alu", "other"]
    # one thread a row at the pipes' peak: issue binds this listing (its
    # branches take issue slots and neither pipe); the FMA pipe binds
    # when its cycles outgrow half the pass
    ms = T.sass_bound_ms(got, 4, 17, 1)
    assert ms == pytest.approx(4 * 2 * got["pass"] / (67e12 / 2) * 1e3)
    heavy = {**got, "fma_cycles": got["pass"]}
    assert T.sass_bound_ms(heavy, 4, 17, 1) == pytest.approx(2 * ms)
