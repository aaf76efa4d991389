"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is what bench.py measures for the JAX package: one halting
``spin`` segment executed by the C++ executor, proved with its paging
companion proof by ``zeth_tpu_torch.circuits.rv32im.prove_segment``, and
both proofs verified. Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel of the path from the sources in the checkout
   (one nvcc per source, all started together);
3. kernels: each kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes, with both times;
4. oracle: a small spin segment proved on the card must hash to the seal
   digests in tests/fixtures/torch_port_seals.json (the CPU seals, which
   tests/test_torch_rv32im.py holds equal to the JAX package's);
5. headline: the po2=20 spin segment and its paging proof, untimed
   inside (as a user runs it), with the kernels' launch counts read
   around this run alone;
6. stages: the same prove again with the prover's stage timers on (each
   stage ends in a device synchronisation), for the breakdown only;
7. verify: both proofs of the headline, with the port's host verifier;
8. stats, then a ``{"kernels": [...]}`` line, the card line, and the
   final ``{"ok": true, ...}`` line.

The script needs a CUDA card: without one it exits non-zero before any
result. It imports no jax and nothing of the JAX package (``zeth_tpu``).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_seals.json")

# the headline segment size: the reference's, and bench.py's BASELINE
PO2 = 20

# the Poseidon2 leaf kernel's shapes: edge cases, then the rv32im main
# group at po2=10 and at po2=20 (2^22 LDE rows x 1009 columns)
LEAF_SHAPES = [(1, 3), (7, 16), (1000, 37), (4096, 1009), (1 << 22, 1009)]

KERNELS = {
    "poseidon2_leaf": {
        "route": "cuda",
        "source": "zeth_tpu_torch/kernels/csrc/poseidon2_leaf.cu",
        "replaces": "zeth_tpu/pallas/poseidon2.py:110",
    },
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def check_leaf_kernel(dev, P) -> dict:
    """The leaf kernel against hash_rows at every shape; times at each."""
    from zeth_tpu_torch.hash import poseidon2 as P2
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    worst, main = 0, None
    for shape in LEAF_SHAPES:
        rows = torch.randint(0, P, shape, dtype=torch.int32, device=dev,
                             generator=gen)
        big = shape[0] >= (1 << 20)
        # warm both up; the plain version's set-up is done before the big
        # shape, whose plain call takes seconds
        P2.leaf_hash(rows)
        if not big:
            P2.hash_rows(rows)
        torch.cuda.synchronize()
        got, ms = cuda_ms(lambda: P2.leaf_hash(rows), 3 if big else 20)
        want, plain_ms = cuda_ms(lambda: P2.hash_rows(rows), 1 if big else 3)
        err = int((got.long() - want.long()).abs().max())
        if got.shape != (shape[0], 8) or not torch.equal(got, want):
            raise SystemExit(f"poseidon2_leaf disagrees with hash_rows at "
                             f"{shape}: max_abs_err {err}")
        worst = max(worst, err)
        log(f"[kernels] poseidon2_leaf {shape}: equal, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        if big:
            main = (ms, plain_ms)
        del rows, got, want
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": main[0], "plain_ms": main[1]}


def spin_segment(spin_iters: int, segment_po2: int):
    from zeth_tpu_torch.executor import Executor, guests, load_image
    elf = guests.spin(spin_iters)
    entry, ia, iw = load_image(elf)
    res = Executor(elf, segment_po2=segment_po2, trace=True).run()
    if len(res.segments) != 1:
        raise SystemExit(f"spin({spin_iters}) gave {len(res.segments)} "
                         "segments, expected one halting segment")
    return res.segments[0], ia, iw


def verify_pair(seal, pg_seal, ia, iw) -> None:
    """Both proofs with the port's verifier, as bench.py checks an EVM
    segment: the paging proof, the rv32im proof bound to it, then g4."""
    from zeth_tpu_torch.circuits.paging import PagingAir
    from zeth_tpu_torch.circuits.rv32im import Rv32imAir
    from zeth_tpu_torch.zkp import proof as proof_mod
    from zeth_tpu_torch.zkp import verifier
    proof, pg_proof = proof_mod.decode(seal), proof_mod.decode(pg_seal)
    pg_pubs = [int(p) for p in pg_proof.publics]
    ppg = PagingAir.parse_publics(pg_pubs)
    verifier.verify(PagingAir(), pg_proof, pg_pubs)
    sampled = verifier.verify(
        Rv32imAir(ia, iw), proof, [int(p) for p in proof.publics],
        derived_extra={"d0": ppg["d0"], "d1": ppg["d1"]},
        extra_mix=pg_proof.roots["main"])
    if not (np.asarray(sampled[4], np.uint64) == ppg["g4"]).all():
        raise SystemExit("paging proof's g4 differs from the rv32im proof's")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port on a GPU only")
    dev = torch.device("cuda", 0)
    from zeth_tpu_torch import kernels
    from zeth_tpu_torch.circuits import rv32im
    from zeth_tpu_torch.hostmath import P
    from zeth_tpu_torch.zkp import prover

    # 1. device
    log(f"[device] {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.time()
    logs = kernels.build_all(force=True)
    for name, out in logs.items():
        log(f"[build] {name}: {out.strip()}")
    log(f"[build] {len(logs)} kernel(s) in {time.time() - t0:.1f} s")

    # 3. kernels against their plain versions
    results = {"poseidon2_leaf": check_leaf_kernel(dev, P)}

    # 4. the small-po2 oracle
    with open(FIXTURE) as f:
        fx = json.load(f)["spin"]
    seg, ia, iw = spin_segment(fx["spin_iters"], fx["segment_po2"])
    t0 = time.time()
    seal, pg_seal = rv32im.prove_segment(seg, ia, iw, device=dev)
    torch.cuda.synchronize()
    if (sha(seal), sha(pg_seal)) != (fx["seal_sha256"], fx["paging_sha256"]):
        raise SystemExit("small-po2 seals differ from the fixture digests")
    log(f"[oracle] spin({fx['spin_iters']}) po2={fx['po2']}: seal and paging "
        f"seal equal the fixture digests ({time.time() - t0:.1f} s)")

    # 5. the headline: one halting PO2 segment (bench.py's guest sizing),
    # proved as a user calls it, with no stage timer synchronising
    t0 = time.time()
    seg, ia, iw = spin_segment(((1 << PO2) - 4096) * 3 // 2, PO2)
    cycles = int(seg.trace.shape[0])
    log(f"[main] spin segment: {cycles} cycles, executed in "
        f"{time.time() - t0:.1f} s")
    prover.TIMING = False
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.time()
    seal, pg_seal = rv32im.prove_segment(seg, ia, iw, device=dev)
    torch.cuda.synchronize()
    prove_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    for name, n in launches.items():
        if n == 0:
            raise SystemExit(f"kernel {name} was not launched by the main "
                             "path")

    # 6. the stage breakdown, from a second prove with the stage timers on
    prover.TIMING = True
    prover.STAGE_LOG.clear()
    t0 = time.time()
    staged = rv32im.prove_segment(seg, ia, iw, device=dev)
    torch.cuda.synchronize()
    staged_s = time.time() - t0
    prover.TIMING = False
    if not all(np.array_equal(a, b) for a, b in zip(staged, (seal, pg_seal))):
        raise SystemExit("the stage-timed prove gave other seals")
    for name, dt in prover.STAGE_LOG:
        log(f"[stage] {name.strip()}: {dt:.3f} s")
    log(f"[stage] prove_segment with stage timers: {staged_s:.3f} s")

    # 7. verify both proofs
    t0 = time.time()
    verify_pair(seal, pg_seal, ia, iw)
    verify_s = time.time() - t0

    # 8. stats and results
    log(f"[main] po2={PO2}: {cycles} cycles, prove_segment {prove_s:.3f} s "
        f"({cycles / prove_s / 1e6:.4f} Mcycles/s), verify {verify_s:.3f} s, "
        f"seal {seal.shape[0]} + paging {pg_seal.shape[0]} words "
        f"({(seal.shape[0] + pg_seal.shape[0]) * 4 / 1024:.1f} KiB), "
        f"peak device memory {peak / 2**30:.2f} GiB, "
        f"launches {launches}")
    print(json.dumps({"kernels": [
        dict(name=name, **KERNELS[name], launches=launches[name],
             **results[name]) for name in kernels.NAMES]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
