"""The port's bit-packed main upload against zeth_tpu's, on the CPU.

The C packer (``executor.pack_rows``, the same ``pack.cpp`` built from the
port's own directory) must pack as the JAX package's does, over one row
range or several threads; ``_pack_spec`` must give the JAX package's spec
for every AIR with a ``main_bit_mask``; ``_unpack_main`` must unpack as the
JAX package's does (words with bit 31 set included); and ``_upload_main``
must give the tensor ``_upload_std`` gives, for each masked AIR and for
the recursion AIR, which has no mask and is shipped raw.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeth_tpu import executor as JEX
from zeth_tpu.circuits import bigint2 as JBI
from zeth_tpu.circuits import keccak as JKE
from zeth_tpu.circuits import paging as JPG
from zeth_tpu.circuits import rv32im as JRV
from zeth_tpu.circuits import sha256 as JSH
from zeth_tpu.zkp import prover as JP
from zeth_tpu_torch import executor as TEX
from zeth_tpu_torch import field as TF
from zeth_tpu_torch.circuits import bigint2 as TBI
from zeth_tpu_torch.circuits import keccak as TKE
from zeth_tpu_torch.circuits import paging as TPG
from zeth_tpu_torch.circuits import rv32im as TRV
from zeth_tpu_torch.circuits import sha256 as TSH
from zeth_tpu_torch.hostmath import P
from zeth_tpu_torch.recursion import builder as TB
from zeth_tpu_torch.recursion import vm as TVM
from zeth_tpu_torch.zkp import prover as TP

torch.set_num_threads(2)

IMAGE = (np.array([0x1000, 0x1004], np.uint64), np.array([7, 9], np.uint64))

# (port AIR, reference AIR) of every AIR with a main_bit_mask
AIRS = {
    "rv32im": lambda: (TRV.Rv32imAir(*IMAGE), JRV.Rv32imAir(*IMAGE)),
    "paging": lambda: (TPG.PagingAir(), JPG.PagingAir()),
    "keccak": lambda: (TKE.KeccakAir(), JKE.KeccakAir()),
    "bigint2": lambda: (TBI.Bigint2Air(), JBI.Bigint2Air()),
    "sha256": lambda: (TSH.Sha256Air(), JSH.Sha256Air()),
}


def _trace(mask, n, seed):
    """(n, cols) uint64 standard-form trace: 0/1 in the bit columns,
    field values in the others."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, P, size=(n, mask.shape[0]), dtype=np.uint64)
    m[:, mask] = rng.integers(0, 2, size=(n, int(mask.sum())),
                              dtype=np.uint64)
    return m


def _pack(mod, m, mask, ranges):
    bit_idx, val_idx = np.nonzero(mask)[0], np.nonzero(~mask)[0]
    packed = np.zeros((m.shape[0], (bit_idx.size + 31) // 32), np.uint32)
    vals = np.zeros((m.shape[0], max(val_idx.size, 1)), np.uint32)
    for r0, r1 in ranges:
        mod.pack_rows(m, bit_idx, val_idx, packed, vals, r0, r1)
    return packed, vals


def test_pack_rows_equals_reference():
    mask = TRV._main_bit_mask()
    n = 4096
    # every column random (the packer keeps bit 0 of a bit column)
    m = np.random.default_rng(1).integers(0, 2**63, size=(n, mask.shape[0]),
                                          dtype=np.uint64)
    want = _pack(JEX, m, mask, [(0, n)])
    single = _pack(TEX, m, mask, [(0, n)])
    step = n // 4
    futs = [TP.staging._pool().submit(_pack, TEX, m, mask, [(r, r + step)])
            for r in range(0, n, step)]
    parts = [f.result() for f in futs]
    threaded = tuple(sum(p[i] for p in parts) for i in range(2))
    for got in (single, threaded):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert want[0].shape == (n, 31) and want[1].shape == (n, 38)


@pytest.mark.parametrize("name", sorted(AIRS))
def test_pack_spec_equals_reference(name):
    tair, jair = AIRS[name]()
    assert tair.name == jair.name
    TP.register_air(tair)
    JP.register_air(jair)
    got, want = TP._pack_spec(tair.name), JP._pack_spec(jair.name)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2:] == want[2:]


def test_unpack_main_equals_reference():
    tair, jair = AIRS["rv32im"]()
    TP.register_air(tair)
    spec, _, n_bits, n_vals = TP._pack_spec(tair.name)
    rng = np.random.default_rng(2)
    n = 512
    # full 32-bit words: bit 31 set in about half of them
    packed = rng.integers(0, 2**32, size=(n, (n_bits + 31) // 32),
                          dtype=np.uint64).astype(np.uint32)
    vals = rng.integers(0, P, size=(n, n_vals), dtype=np.uint64) \
        .astype(np.uint32)
    assert (packed >> 31).any()
    want = np.asarray(JP._unpack_main(jnp.asarray(packed), jnp.asarray(vals),
                                      spec))
    got = TP._unpack_main(torch.from_numpy(packed.view(np.int32)),
                          torch.from_numpy(vals.view(np.int32)), spec)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _recursion_air():
    b = TB.Builder()
    x = b.input()
    b.bind_public(b.add(x, x), 0)
    return TVM.RecursionAir(b.build())


@pytest.mark.parametrize("name", sorted(AIRS) + ["recursion"])
def test_upload_main_equals_upload_std(name, monkeypatch):
    if name == "recursion":
        air = _recursion_air()
        assert getattr(air, "main_bit_mask", None) is None
        mask = np.zeros(air.main_cols, bool)
    else:
        air = AIRS[name]()[0]
        mask = np.asarray(air.main_bit_mask, bool)
    # rv32im at 2 x 8192 rows: the packer runs on two threads
    n = 1 << 14 if name == "rv32im" else 512
    # small row chunks in the unpack
    monkeypatch.setattr(TF, "CHUNK_ELEMS", 100 * air.main_cols)
    unpacked = []
    real = TP._unpack_main
    monkeypatch.setattr(TP, "_unpack_main", lambda p, v, spec: unpacked.append(
        (tuple(p.shape), tuple(v.shape))) or real(p, v, spec))
    for seed in (3, 4):        # the second upload reuses the host buffers
        m = _trace(mask, n, seed)
        got = TP._upload_main(air, m, torch.device("cpu"))
        assert torch.equal(got, TP._upload_std(m, "cpu"))
    if name == "recursion":
        assert unpacked == []
    else:
        _, _, n_bits, n_vals = TP._pack_spec(air.name)
        assert unpacked == [((n, (n_bits + 31) // 32), (n, max(n_vals, 1)))] * 2


def test_failed_packer_build_raises_with_makes_output(tmp_path, monkeypatch):
    """No fallback: a libpack.so that does not build raises, with the
    compiler's message."""
    import os
    import shutil
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    shutil.copy(os.path.join(TEX._DIR, "csrc", "Makefile"), csrc)
    (csrc / "pack.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(TEX, "_DIR", str(tmp_path))
    monkeypatch.setattr(TEX, "_PACK_SO", str(csrc / "libpack.so"))
    monkeypatch.setattr(TEX, "_PACK_LIB", None)
    with pytest.raises(RuntimeError, match="make exit") as e:
        TEX._pack_lib()
    assert "pack.cpp" in str(e.value)


def test_commit_main_equals_plain_upload_commit():
    """commit_main (bit-packed upload, then the radix-2 LDE) commits the
    same root as the plain upload."""
    from zeth_tpu_torch.hash import merkle as TM
    air = AIRS["paging"]()[0]
    m = _trace(np.asarray(air.main_bit_mask, bool), 256, 5)
    want = TM.commit_rows(TP._lde(TP._upload_std(m, "cpu"), std=True)).root
    np.testing.assert_array_equal(TP.commit_main(air, m, "cpu")[0], want)
