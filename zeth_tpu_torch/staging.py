"""Reusable host staging buffers with parallel first-touch.

Fresh multi-GB numpy allocations can fault slowly (the kernel's
demand-zero path is single-threaded), so a large witness matrix may cost
many seconds before a single element is written. Two fixes, both here:

  * buffers are cached per (key, shape, dtype) and reused across calls
    (pages stay resident — later uses pay only the overwrite), and
  * the first touch runs `.fill()` across a small thread pool — page
    faults parallelize across cores.

Jax-free copy of ``zeth_tpu.staging``. Used by the rv32im witgen, which
allocates a trace-sized host matrix every segment.
"""

from __future__ import annotations

import concurrent.futures as _cf
import os

import numpy as np

_BUFS: dict = {}
_POOL: _cf.ThreadPoolExecutor | None = None
_N_THREADS = min(8, (os.cpu_count() or 1) * 2)


def _pool() -> _cf.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = _cf.ThreadPoolExecutor(_N_THREADS)
    return _POOL


def _parallel_fill(a: np.ndarray, value) -> None:
    """Fill a (possibly fresh) array using all cores; numpy's .fill
    releases the GIL, so threads fault distinct page ranges in parallel."""
    flat = a.reshape(-1)
    n = flat.shape[0]
    if n < (1 << 22):            # < 32 MB of u64: not worth the pool
        flat.fill(value)
        return
    step = -(-n // _N_THREADS)
    futs = [_pool().submit(flat[i:i + step].fill, value)
            for i in range(0, n, step)]
    for f in futs:
        f.result()


def staged(key: str, shape: tuple, dtype, zero: bool = False) -> np.ndarray:
    """A reusable host buffer. Contents are arbitrary unless zero=True."""
    k = (key, tuple(shape), np.dtype(dtype).str)
    buf = _BUFS.get(k)
    if buf is None:
        buf = np.empty(shape, dtype)
        _parallel_fill(buf, 0)           # first touch: fault pages in parallel
        _BUFS[k] = buf
    elif zero:
        _parallel_fill(buf, 0)
    return buf
