"""What a run loads, and what the reference loads, by top-level module
name compared whole (the port's name begins with the JAX package's).
Each check imports in a fresh interpreter, since pytest's own plugins
may load JAX into this one."""

import glob
import json
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "zeth_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
         "import json; print(json.dumps(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    """Everything a run imports: the harness, every entry, reader and
    reference module, and the port's modules the entries drive."""
    code = "\n".join([
        "import run",
        "from harness import cell, peaks, spec, trace, traffic, window",
        "import reference.check",
        "for w in spec.load_json('BENCHMARK.json')['workloads']:",
        "    c = spec.load(w['name'])",
        "    [c.reader(m['name']) for m in c.per_layer]",
        "from zeth_tpu_torch.app import guest_input, host, chainspec",
        "from zeth_tpu_torch.circuits import keccak, rv32im, paging",
        "from zeth_tpu_torch.executor import Executor",
        "from zeth_tpu_torch import kernels",
        "from zeth_tpu_torch.zkp import prover, verifier",
    ])
    loaded = _loaded(code)
    assert "zeth_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(os.path.relpath(p, BENCH)[:-3].replace(os.sep, ".")
                  for p in glob.glob(os.path.join(BENCH, "reference",
                                                  "**", "*.py"),
                                     recursive=True))
    code = "\n".join(f"import {m.removesuffix('.__init__')}" for m in mods)
    loaded = _loaded(code)
    assert "reference" in loaded
    assert not loaded & (FORBIDDEN | {"zeth_tpu_torch"})
