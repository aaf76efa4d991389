"""ctypes loader for the native recursion-VM witgen (executor/csrc/recvm.cpp).

Counterpart of ``zeth_tpu.recursion.witgen_native``. The library is built
with ``make`` from the port's own ``executor/csrc/`` at first use (and
again when ``recvm.cpp`` is newer than it). A failed build or load raises
with the compiler's output: there is no other interpreter on the proving
path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..hash import poseidon2 as P2
from .vm import ML, Program

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "executor", "csrc")
_SO = os.path.join(_DIR, "librecvm.so")
_LIB = None


def _build() -> None:
    proc = subprocess.run(["make", "-s", "-C", _DIR, "librecvm.so"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SO} failed (make exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")


def _lib():
    global _LIB
    if _LIB is None:
        src = os.path.join(_DIR, "recvm.cpp")
        if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(src)):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.rec_witgen.restype = ctypes.c_int
        lib.rec_witgen.argtypes = [
            ctypes.c_long, ctypes.c_long,                       # n_rows, n
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # typ,addr,rc
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # -,s,wf
            ctypes.c_void_p, ctypes.c_long,                     # stream,len
            ctypes.c_void_p, ctypes.c_long,                     # mu, n_cells
            ctypes.c_void_p, ctypes.c_void_p]                   # main, wom
        _LIB = lib
    return _LIB


def run(pr: Program, stream: np.ndarray, n: int):
    """(main (n, ML.N), WOM (n_cells, 4)) standard-form uint64 of `pr`
    interpreted over `stream` on an n-row trace."""
    lib = _lib()
    typ = np.ascontiguousarray(pr.typ, dtype=np.uint16)
    addr = np.ascontiguousarray(pr.addr, dtype=np.int64)
    rc = np.ascontiguousarray(pr.rc, dtype=np.uint32)
    s = np.ascontiguousarray(pr.s, dtype=np.uint32)
    wf = np.ascontiguousarray(pr.wf, dtype=np.int64)
    stream = np.ascontiguousarray(stream, dtype=np.uint64)
    mu = np.ascontiguousarray(P2.constants()["diag"], dtype=np.uint64)
    main = np.zeros((n, ML.N), dtype=np.uint64)
    wom = np.zeros((pr.n_cells, 4), dtype=np.uint64)
    rc_ = lib.rec_witgen(
        pr.n_rows, n, typ.ctypes.data, addr.ctypes.data, rc.ctypes.data,
        None, s.ctypes.data, wf.ctypes.data, stream.ctypes.data,
        stream.shape[0], mu.ctypes.data, pr.n_cells,
        main.ctypes.data, wom.ctypes.data)
    if rc_ != 0:
        raise RuntimeError(f"rec_witgen failed with code {rc_}")
    return main, wom
