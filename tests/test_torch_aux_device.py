"""The port's ``build_aux_device`` against the host oracles of both packages.

``zeth_tpu_torch.circuits.rv32im.Rv32imAir.build_aux_device`` (a torch
composition, run here on the CPU) must equal, word for word after
``from_monty`` (tolerance 0), the port's host ``build_aux`` and
``zeth_tpu``'s host ``build_aux`` on the same numpy main trace and the same
seeded challenges, on segments that fill every argument: input and journal
streams, loads and stores, and the keccak, bigint and sha-256 syscalls.
The reference holds its own device twin to the same host oracle
(tests/test_rv32im.py::test_build_aux_device_matches_host), which needs no
XLA compile here.

The prover takes the device twin whenever the AIR has one; the seal of
the fixture spin segment must not change for it.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from zeth_tpu.circuits import rv32im as JRV
from zeth_tpu_torch import field as TF
from zeth_tpu_torch.circuits import rv32im as TRV
from zeth_tpu_torch.executor import Executor, guests, load_image
from zeth_tpu_torch.hostmath import P

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_seals.json")

# the aux group's 27 blocks of 4 columns, in the order of the concatenation
BLOCKS = ["t", "u", "acc", "t_r1", "t_r2", "t_w", "t_a7", "s0", "s1", "s2",
          "s3", "racc", "mu_r", "mu_w", "msort0", "msort1", "macc", "li",
          "lf", "liacc", "lfacc", "r_j", "r_k", "r_b", "r_sh", "r_re", "r_rx"]

SHA_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
          0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

GUESTS = {
    "echo": lambda: (guests.echo_input(16), bytes(range(16))),
    "load_store": lambda: (guests.load_store(), b""),
    "keccak": lambda: (guests.keccak_guest(1), b""),
    "bigint": lambda: (guests.bigint_guest(
        0xDEADBEEF_CAFEBABE, 0x12345678_9ABCDEF0, (1 << 89) - 1, reps=2), b""),
    "sha256": lambda: (guests.sha256_guest(SHA_IV, list(range(16)), reps=2),
                       b""),
}

# blocks that the guest must drive away from zero, so that the comparison
# is not one of empty columns
MUST_FILL = {
    "echo": ["r_j", "mu_r", "mu_w", "msort0", "msort1", "li", "lf"],
    "load_store": ["mu_r", "mu_w", "macc", "liacc", "lfacc"],
    "keccak": ["r_k"],
    "bigint": ["r_b"],
    "sha256": ["r_sh"],
}


def _to_cpu(a_std) -> torch.Tensor:
    return torch.from_numpy(
        np.asarray(a_std, np.uint64).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("guest", list(GUESTS))
def test_build_aux_device_equals_host_oracles(guest):
    elf, inp = GUESTS[guest]()
    _, ia, iw = load_image(elf)
    res = Executor(elf, inp, segment_po2=12, trace=True).run()
    seg = res.segments[0]
    air = TRV.Rv32imAir(ia, iw)
    po2 = TRV.choose_po2(seg, len(ia))
    main, _ = air.witgen(seg, po2)
    main = np.asarray(main, np.uint64).copy()
    rng = np.random.default_rng(3)
    chal = rng.integers(1, P, size=(air.n_challenges, 4)).astype(np.uint64)

    got_m = air.build_aux_device(_to_cpu(main),
                                 _to_cpu(air.control_trace(po2)), chal)
    assert got_m.dtype == torch.int32 and got_m.shape == (1 << po2, TRV.N_AUX)
    got = TF.from_monty(got_m).numpy().astype(np.uint64)

    oracles = {
        "port host build_aux": air.build_aux(main, chal),
        "zeth_tpu host build_aux": JRV.Rv32imAir(ia, iw).build_aux(main, chal),
    }
    for name, want in oracles.items():
        want = np.asarray(want, np.uint64) % np.uint64(P)
        bad = np.nonzero((got != want).any(axis=0))[0]
        assert bad.size == 0, (f"{guest}: differs from the {name} first in "
                               f"block {BLOCKS[bad[0] // 4]} (column {bad[0]})")
    for block in MUST_FILL[guest]:
        k = BLOCKS.index(block)
        assert got[:, 4 * k:4 * k + 4].any(), f"{guest}: block {block} is empty"


def test_rlc_chain_scan_equals_sequential_recurrence():
    """The log-step affine scan against the plain recurrence, on stacked
    chains whose active rows include the first and the last."""
    rng = np.random.default_rng(11)
    n, k = 37, 3
    act = (rng.random((n, k)) < 0.4).astype(np.int64)
    act[0, 0] = act[-1, 0] = 1
    val = rng.integers(0, P, size=(n, k, 4)).astype(np.int64)
    g = torch.from_numpy(rng.integers(1, P, size=4).astype(np.int64))
    g_m, one = TF.to_monty(g), TF.to_monty(torch.tensor([1, 0, 0, 0]))
    val_m = TF.to_monty(torch.from_numpy(val))
    got = TRV._dx_rlc_chain(TF.to_monty(torch.from_numpy(act)), val_m, g_m,
                            one)
    r = torch.zeros((k, 4), dtype=torch.int32)
    for i in range(n):
        step = TF.ext_add(TF.ext_mul(r, g_m.expand(k, 4)), val_m[i])
        r = torch.where(torch.from_numpy(act[i])[:, None] != 0, step, r)
        assert torch.equal(got[i], r), f"row {i}"


def test_prove_with_device_aux_keeps_fixture_seal(monkeypatch):
    with open(FIXTURE) as f:
        fx = json.load(f)["spin"]
    elf = guests.spin(fx["spin_iters"])
    _, ia, iw = load_image(elf)
    res = Executor(elf, segment_po2=fx["segment_po2"], trace=True).run()
    calls = []
    device_aux = TRV.Rv32imAir.build_aux_device

    def counted(self, *a):
        calls.append(a[0].device.type)
        return device_aux(self, *a)

    def host_aux(self, *a):
        raise AssertionError("the prover took the host build_aux of an AIR "
                             "that has a device twin")

    monkeypatch.setattr(TRV.Rv32imAir, "build_aux_device", counted)
    monkeypatch.setattr(TRV.Rv32imAir, "build_aux", host_aux)
    seal, pg_seal = TRV.prove_segment(res.segments[0], ia, iw, device="cpu")
    assert calls == ["cpu"]
    sha = lambda w: hashlib.sha256(
        np.asarray(w, dtype="<u4").tobytes()).hexdigest()
    assert sha(seal) == fx["seal_sha256"]
    assert sha(pg_seal) == fx["paging_sha256"]
