"""The port's import sets glibc's allocator as the reference's does.

``zeth_tpu/__init__.py`` raises ``M_MMAP_THRESHOLD`` to 1 GiB and
``M_TRIM_THRESHOLD`` to 256 MiB, so large numpy buffers come from the
heap's free list and not from a fresh mmap each. The setting belongs to
the process, and this test process has imported ``zeth_tpu`` already, so
each case runs in a fresh interpreter: the port's case with ``jax``,
``jaxlib`` and ``zeth_tpu`` blocked (the hook of ``test_torch_nojax``),
the control with neither package imported. Each reads the bytes glibc
mmapped for one large numpy array through ``chip_smoke.mmapped_mib``
(``mallinfo2().hblkhd`` around it), which ``chip_smoke.py`` prints as its
``[malloc]`` line on the card; the script imports neither package.
"""

import ctypes
import os
import subprocess
import sys

import pytest

from test_torch_nojax import HOOK, ROOT

PORT = HOOK + "import zeth_tpu_torch\n"

# case -> (set-up, measurement, least and most MiB mmapped)
CASES = {
    # the port's import keeps a main-thread block off mmap
    "port_main_thread": (PORT, "mmapped_mib(256 << 20)", 0, 0),
    # without it glibc mmaps the same block
    "control_main_thread": ("", "mmapped_mib(256 << 20)", 256, None),
    # a worker thread's arena mmaps any block over its 64 MiB heap,
    # whatever the threshold; a smaller block stays on its heap
    "port_worker_thread_large": (PORT, "mmapped_mib(256 << 20, True)", 256,
                                 None),
    "port_worker_thread_small": (PORT, "mmapped_mib(48 << 20, True)", 0, 0),
}


def _has_mallinfo2() -> bool:
    if not sys.platform.startswith("linux"):
        return False
    try:
        return hasattr(ctypes.CDLL("libc.so.6"), "mallinfo2")
    except OSError:
        return False


@pytest.mark.skipif(not _has_mallinfo2(),
                    reason="needs Linux and glibc >= 2.33 (mallinfo2)")
@pytest.mark.parametrize("case", sorted(CASES))
def test_mmapped_bytes_around_a_large_array(case):
    setup, expr, least, most = CASES[case]
    body = setup + f"import chip_smoke\nprint(chip_smoke.{expr})\n"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", body], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    mib = float(proc.stdout.split()[-1])
    assert mib >= least and (most is None or mib <= most), \
        f"{case}: {mib} MiB mmapped"
