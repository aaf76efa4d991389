"""Hand-written CUDA kernels: build, load and launch counts.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; both
include ``csrc/poseidon2.cuh``, the one copy of the field arithmetic
(Montgomery products of five dependent instructions, two-instruction
additions), the round constants and the permutation as one warp computes
it. A kernel is compiled by ``nvcc`` for ``sm_90a`` into ``zeth_tpu_torch/build/lib<name>.so``
at first use (or by ``build_all``, which starts one ``nvcc`` per source at
once) and loaded with ``ctypes``; a library is rebuilt when its source, or
any file under ``csrc/`` that the source includes, is newer. Nothing is
compiled or loaded when this module is imported, so CPU-only machines
import the package freely.

``LAUNCHES`` counts, per kernel, the launches its wrapper has made, and
``LAUNCH_SHAPES`` the same launches by (rows, cols); a wrapper adds to
both where it launches its kernel and nowhere else (``count``).

Kernels (two; on the CPU each wrapper runs its plain version,
``hash_rows``, which the CPU tests hold equal to the JAX package's; on
the card ``chip_smoke.py`` phase 3 holds each kernel equal to it):

* ``poseidon2_leaf`` -- the Poseidon2 Merkle leaf sponge; wrapper
  ``zeth_tpu_torch.hash.poseidon2.leaf_hash``, behind every Merkle tree.
  One thread a row where the matrix has rows enough to fill the card, 8
  lanes a row below that, a warp a row (the sponge kernel's permutation)
  for the fewest rows: one rule on the rows and the card's SM count, in
  the source (``poseidon2_leaf_mapping`` says which it takes).
* ``poseidon2_sponge`` -- the same sponge, one warp per row, for one long
  row (the claims and publics digests); wrapper
  ``zeth_tpu_torch.hash.poseidon2.sponge_hash``, which only
  ``sponge_row`` calls.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
BUILD = os.path.join(os.path.dirname(_DIR), "build")

NAMES = ("poseidon2_leaf", "poseidon2_sponge")
LAUNCHES: dict[str, int] = {name: 0 for name in NAMES}
LAUNCH_SHAPES: dict[str, collections.Counter] = {
    name: collections.Counter() for name in NAMES}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_SHAPES[name].clear()


def count(name: str, rows: int, cols: int) -> None:
    """One launch of kernel `name` on an (rows, cols) matrix."""
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[name][(rows, cols)] += 1


def _nvcc() -> str:
    """nvcc from PATH, else from the toolkit's install prefix."""
    path = shutil.which("nvcc")
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    if path is None and os.path.exists(os.path.join(home, "bin", "nvcc")):
        path = os.path.join(home, "bin", "nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD, f"lib{name}.so"),
            os.path.join(BUILD, f"lib{name}.log"))


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(src: str) -> set[str]:
    """`src` and every file under ``CSRC`` that it includes, directly or
    through another such file (``#include "..."``)."""
    seen, todo = set(), [src]
    while todo:
        path = todo.pop()
        if path in seen or not os.path.exists(path):
            continue
        seen.add(path)
        with open(path) as f:
            todo += [os.path.join(CSRC, inc)
                     for inc in _INCLUDE.findall(f.read())]
    return seen


def _stale(name: str) -> bool:
    src, so, _ = _paths(name)
    return not os.path.exists(so) or any(
        os.path.getmtime(so) < os.path.getmtime(path)
        for path in _sources(src))


def build_all(names=NAMES, force: bool = False) -> dict[str, str]:
    """Compile the kernels (one nvcc process per source, all started
    together). Returns {name: compiler output}; raises if any build fails."""
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        src, so, log = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so, log)
    logs, failed = {}, []
    for name, (proc, tmp, so, log) in procs.items():
        out, _ = proc.communicate()
        with open(log, "w") as f:
            f.write(out)
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(_paths(name)[1])
        _LIBS[name] = lib
    return lib
