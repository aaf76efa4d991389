"""zeth_tpu_torch and chip_smoke.py import no jax and no zeth_tpu.

The machine with the GPU has no jax. A fresh interpreter with an import
hook that refuses ``jax``, ``jaxlib`` and the JAX package ``zeth_tpu``
stands in for it: every module of the port, and the chip smoke script,
must import there, and a small prove must run.
"""

import hashlib
import os
import subprocess
import sys
import textwrap

import pytest

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
        print(" ".join(names))
    """)
    names = out.split()
    assert len(names) >= 38
    for name in ("hash.keccak", "app.rlp", "app.chainspec", "app.trie",
                 "app.state", "app.txs", "app.host", "app.kzg",
                 "app.bls12381", "app.guest_input", "cc", "cc.compiler",
                 "hash.sha256", "circuits.keccak", "circuits.bigint2",
                 "circuits.sha256", "circuits.resolve", "zkvm", "recursion",
                 "recursion.vm",
                 "recursion.witgen_native", "recursion.builder",
                 "recursion.compiler", "recursion.succinct",
                 "recursion.scheduler", "app.evm", "app.bn254",
                 "app.preflight", "app.rpc_proxy", "app.cli",
                 "app.run_parallel", "zkp.groth16", "mxu", "parallel",
                 "parallel.comm", "parallel.dist_ntt", "parallel.commit",
                 "parallel.multihost"):
        assert "zeth_tpu_torch." + name in names


def test_port_tools_import_no_jax():
    """The port's scripts (tools/torch_*.py) import no jax and no zeth_tpu,
    at the top or inside a function (they need a card to run), and load
    in the blocked interpreter."""
    import ast
    import glob
    paths = sorted(glob.glob(os.path.join(ROOT, "tools", "torch_*.py")))
    assert len(paths) >= 2
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "jaxlib", "zeth_tpu"), \
                    f"{os.path.basename(path)} imports {m}"
    _run("""
        import glob, importlib.util, os
        for path in sorted(glob.glob("tools/torch_*.py")):
            spec = importlib.util.spec_from_file_location(
                os.path.basename(path)[:-3], path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
    """)


def test_stateless_guest_builds_and_runs_without_jax():
    """The EVM segment's front end, as the card's machine runs it: build
    the guest ELF, encode the smaller fixture block, execute untraced."""
    out = _run("""
        import glob, json, os
        from zeth_tpu_torch.app.chainspec import MAINNET
        from zeth_tpu_torch.app.guest_input import (build_stateless_elf,
                                                    encode_guest_input)
        from zeth_tpu_torch.app.host import StatelessInput
        from zeth_tpu_torch.executor import Executor
        path = sorted(glob.glob("tests/fixtures/input_0x*.json"),
                      key=os.path.getsize)[0]
        with open(path) as f:
            inp = StatelessInput.from_json(json.load(f))
        raw = encode_guest_input(inp, MAINNET.chain_id)
        res = Executor(build_stateless_elf(), input_bytes=raw,
                       segment_po2=20).run()
        assert res.exit_code == 0 and res.journal == inp.block.hash()
        print("segments", len(res.segments))
    """)
    assert int(out.split()[-1]) > 1


def test_recursion_lift_program_without_jax():
    """The recursion VM as the card's machine runs it: a hand program
    through the native interpreter, and a toy proof's lift program
    compiled, its stream interpreted and its constraints checked."""
    out = _run("""
        import numpy as np, torch
        torch.set_num_threads(2)
        from zeth_tpu_torch.circuits.toy import SquareChainAir
        from zeth_tpu_torch.hash import poseidon2
        from zeth_tpu_torch.recursion import builder, compiler, succinct, vm
        from zeth_tpu_torch.zkp import prover
        from zeth_tpu_torch.zkp.air import check_constraints
        b = builder.Builder()
        d = b.sponge_hash(b.inputs(3))
        pr = b.build()
        _, wom = vm.RecursionAir(pr).witgen(np.array([1, 2, 3], np.uint64))
        assert [int(wom[c][0]) for c in d] == [int(x) for x in
            poseidon2.hash_rows_np(np.array([[1, 2, 3]], np.uint64))[0]]
        air = SquareChainAir()
        # x0 = 8: a small proof-of-work nonce, a short CPU grind
        main, pubs = SquareChainAir.witgen(5, x0=8)
        proof = prover.prove(air, main, pubs, device="cpu")
        vp = succinct.lift_program(air, 5, len(pubs), device="cpu")
        rair = vp.air()
        m, _ = rair.witgen(compiler.proof_to_stream(vp, proof))
        claim = compiler.claim_digest(5, pubs, device="cpu")
        chal = np.array([[3, 5, 7, 11], [13, 17, 19, 23]], np.uint64)
        bad = check_constraints(rair, rair.control_trace(vp.program.po2()),
                                m, rair.build_aux(m, chal),
                                publics=[int(x) for x in claim],
                                challenges=chal)
        assert bad == {}, bad
        print("lift rows", vp.program.n_rows)
    """)
    assert "lift rows" in out


def test_toy_prove_and_verify_without_jax():
    out = _run("""
        import torch
        torch.set_num_threads(2)
        from zeth_tpu_torch.circuits.toy import SquareChainAir
        from zeth_tpu_torch.zkp import proof, prover, verifier
        air = SquareChainAir()
        main, pubs = SquareChainAir.witgen(5, x0=3)
        seal = proof.encode(prover.prove(air, main, pubs, device="cpu"))
        verifier.verify(air, proof.decode(seal), pubs, device="cpu")
        print("verified", seal.shape[0])
    """)
    assert "verified" in out


def _default_device_calls():
    """name -> call of a repaired entry point with no ``device``."""
    import numpy as np

    from zeth_tpu_torch import convert, zkvm
    from zeth_tpu_torch.app.host import BlockProcessor
    from zeth_tpu_torch.circuits import bigint2, keccak, rv32im, sha256
    from zeth_tpu_torch.circuits.toy import SquareChainAir
    from zeth_tpu_torch.executor import Executor, guests, load_image
    from zeth_tpu_torch.hash import poseidon2
    from zeth_tpu_torch.recursion import compiler, succinct
    from zeth_tpu_torch.zkp import prover, verifier
    from zeth_tpu_torch.zkp.transcript import Transcript

    def toy():
        return (SquareChainAir(), *SquareChainAir.witgen(5, x0=3))

    def segment():
        elf = guests.sum_loop(20)
        _, ia, iw = load_image(elf)
        seg = Executor(elf, segment_po2=12, trace=True).run().segments[0]
        return seg, ia, iw

    def receipt():
        # no seal is read before the device is resolved
        return zkvm.Receipt(journal=b"", claim=zkvm.ReceiptClaim(
            image_id=np.zeros(8, np.uint64),
            journal_digest=hashlib.sha256(b"").digest(), exit_code=0),
            inner=zkvm.SegmentsInner())

    return {
        "to_tensor": lambda: convert.to_tensor(np.arange(4, dtype=np.uint32)),
        "grind": lambda: Transcript().grind(4),
        "commit_main": lambda: prover.commit_main(*toy()[:2]),
        "prove": lambda: prover.prove(*toy()),
        "prove_segments": lambda: (lambda s, ia, iw: rv32im.prove_segments(
            [s], ia, iw))(*segment()),
        "prove_segment": lambda: rv32im.prove_segment(*segment()),
        # with a mesh the device is resolved before the mesh is used
        "prove(mesh)": lambda: prover.prove(*toy(), mesh=object()),
        "prove_segments(mesh)": lambda: (
            lambda s, ia, iw: rv32im.prove_segments([s], ia, iw,
                                                    mesh=object()))(
            *segment()),
        "keccak.prove_batch": lambda: keccak.prove_batch(
            np.zeros((1, 25), np.uint64)),
        "bigint2.prove_batch": lambda: bigint2.prove_batch([(3, 5, 7)]),
        "sha256.prove_batch": lambda: sha256.prove_batch(
            np.zeros((1, 8), np.uint64), np.zeros((1, 16), np.uint64)),
        "LocalProver.prove": lambda: zkvm.LocalProver().prove(
            zkvm.ExecutorEnv.builder().build(), guests.sum_loop(5)),
        # the device is resolved before the proof is read
        "verify": lambda: verifier.verify(SquareChainAir(), None, []),
        "succinct.lift": lambda: succinct.lift(SquareChainAir(), None),
        "succinct.join": lambda: succinct.join(None, None),
        "succinct.aggregate_segments": lambda:
            succinct.aggregate_segments(None, [], None, [], []),
        "succinct.verify_root_segments": lambda:
            succinct.verify_root_segments(None, None, [], [], [], None, [],
                                          [], []),
        "compiler.claim_digest": lambda: compiler.claim_digest(9, [1, 2]),
        "poseidon2.sponge_row": lambda: poseidon2.sponge_row([1, 2, 3]),
        "compiler.expected_control_root": lambda:
            compiler.expected_control_root(SquareChainAir(), 5),
        "Receipt.verify": lambda: receipt().verify(np.zeros(8, np.uint64)),
        "keccak.verify_batch": lambda: keccak.verify_batch(_empty_seal()),
        "bigint2.verify_batch": lambda: bigint2.verify_batch(_empty_seal()),
        "sha256.verify_batch": lambda: sha256.verify_batch(_empty_seal()),
        "BlockProcessor.prove": lambda:
            BlockProcessor.for_chain_id(1).prove(None),
    }


def _empty_seal():
    """A seal that decodes and holds nothing: the verifier resolves its
    device before it reads the proof."""
    import numpy as np

    from zeth_tpu_torch.zkp import fri, proof
    from zeth_tpu_torch.zkp.prover import StarkProof
    return proof.encode(StarkProof(
        air_name="empty", po2=6, publics=[], roots={},
        taps=np.zeros(0, np.uint64),
        fri_proof=fri.FriProof(layer_roots=[],
                               final_coeffs=np.zeros(0, np.uint64),
                               openings=[[] for _ in range(fri.QUERIES)],
                               pow_nonce=0),
        openings={}, query_indices=[]))


@pytest.mark.parametrize("entry", ["to_tensor", "grind", "commit_main",
                                   "prove", "prove_segments",
                                   "prove_segment", "prove(mesh)",
                                   "prove_segments(mesh)",
                                   "keccak.prove_batch",
                                   "bigint2.prove_batch",
                                   "sha256.prove_batch",
                                   "LocalProver.prove", "verify",
                                   "succinct.lift", "succinct.join",
                                   "succinct.aggregate_segments",
                                   "succinct.verify_root_segments",
                                   "compiler.claim_digest",
                                   "poseidon2.sponge_row",
                                   "compiler.expected_control_root",
                                   "Receipt.verify", "keccak.verify_batch",
                                   "bigint2.verify_batch",
                                   "sha256.verify_batch",
                                   "BlockProcessor.prove"])
def test_entry_point_without_device_raises_without_cuda(monkeypatch, entry):
    """The entry points run on the card by default; where there is none
    they raise and do not carry on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ZETH_DEV_MODE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _default_device_calls()[entry]()


def test_entry_point_runs_on_the_cpu_on_request():
    from zeth_tpu_torch import convert
    assert convert.resolve_device("cpu").type == "cpu"
    assert convert.to_tensor([1, 2], device="cpu").device.type == "cpu"


def test_dev_mode_receipt_verifies_without_cuda(monkeypatch):
    """A dev-mode receipt carries no seal and needs no card to verify."""
    import numpy as np
    import torch

    from zeth_tpu_torch import zkvm
    from zeth_tpu_torch.executor import compute_image_id, guests
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ZETH_DEV_MODE", "1")
    elf = guests.sum_loop(10)
    info = zkvm.default_prover().prove(zkvm.ExecutorEnv.builder().build(), elf)
    assert isinstance(info.receipt.inner, zkvm.FakeInner)
    info.receipt.verify(compute_image_id(elf))
    with pytest.raises(zkvm.VerificationError, match="image id"):
        info.receipt.verify(np.zeros(8, np.uint64))
