"""zeth_tpu_torch and chip_smoke.py import no jax and no zeth_tpu.

The machine with the GPU has no jax. A fresh interpreter with an import
hook that refuses ``jax``, ``jaxlib`` and the JAX package ``zeth_tpu``
stands in for it: every module of the port, and the chip smoke script,
must import there, and a small prove must run.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOOK = textwrap.dedent("""
    import importlib.abc, sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "zeth_tpu"):
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, NoJax())
""")


def _run(body: str) -> str:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", HOOK + textwrap.dedent(body)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_every_port_module_imports_without_jax():
    out = _run("""
        import importlib, pkgutil
        import zeth_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            zeth_tpu_torch.__path__, "zeth_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "zeth_tpu")
                       for m in sys.modules)
        print(len(names))
    """)
    assert int(out.split()[-1]) >= 20


def test_toy_prove_and_verify_without_jax():
    out = _run("""
        import torch
        torch.set_num_threads(2)
        from zeth_tpu_torch.circuits.toy import SquareChainAir
        from zeth_tpu_torch.zkp import proof, prover, verifier
        air = SquareChainAir()
        main, pubs = SquareChainAir.witgen(5, x0=3)
        seal = proof.encode(prover.prove(air, main, pubs))
        verifier.verify(air, proof.decode(seal), pubs)
        print("verified", seal.shape[0])
    """)
    assert "verified" in out
