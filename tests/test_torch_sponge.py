"""The one-row Poseidon2 sponge (``sponge_row`` / ``sponge_hash``) against
zeth_tpu.

On the CPU ``sponge_hash`` runs the plain ``hash_rows``; the CUDA kernel
behind it (kernels/csrc/poseidon2_sponge.cu) runs only on a card, where
chip_smoke.py phase 3 holds it equal to ``hash_rows`` and to the leaf
kernel. Here the digests that take it on the card (``sponge_row``, the
bigint claims digest) must equal the JAX package's host sponge, and the
wrapper must refuse what the kernel does not take.
"""

import numpy as np
import pytest
import torch

from zeth_tpu.circuits import bigint2 as JB
from zeth_tpu.hash import poseidon2 as JP2
from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch import kernels
from zeth_tpu_torch.circuits import bigint2 as TB
from zeth_tpu_torch.hash import poseidon2 as TP2

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 4097])
def test_sponge_row_equals_reference(n):
    values = np.random.default_rng(40 + n).integers(0, H.P, n,
                                                    dtype=np.uint64)
    np.testing.assert_array_equal(TP2.sponge_row(values, device="cpu"),
                                  JP2.hash_rows_np(values[None])[0])


def test_bigint_claims_digest_equals_reference():
    # the fixture's small bigint batch (tests/fixtures/torch_port_seals.json)
    io = [(a, b, m, a * b % m) for a, b, m in [(3, 5, 7), (11, 13, 17)]]
    np.testing.assert_array_equal(TB.claims_digest(io, device="cpu"),
                                  JB.claims_digest(io))


def test_sponge_hash_on_cpu_is_the_plain_sponge():
    rows = torch.from_numpy(np.random.default_rng(41).integers(
        0, H.P, (5, 37), dtype=np.uint32).view(np.int32))
    before = dict(kernels.LAUNCHES)
    assert torch.equal(TP2.sponge_hash(rows), TP2.hash_rows(rows))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("rows", [
    torch.zeros((1, 4), dtype=torch.int32, device="meta"),
    torch.zeros((1, 4), dtype=torch.int64),
    torch.zeros((1, 4, 2), dtype=torch.int32),
    torch.zeros((4, 6), dtype=torch.int32)[:, ::2],
    torch.zeros((1, 0), dtype=torch.int32),
], ids=["meta", "int64", "3-D", "non-contiguous", "empty"])
def test_sponge_hash_rejects_what_the_kernel_does_not_take(rows):
    with pytest.raises(ValueError, match="sponge_hash"):
        TP2.sponge_hash(rows)


def test_kernels_name_the_sponge():
    assert kernels.NAMES == ("poseidon2_leaf", "poseidon2_sponge")
    assert set(kernels.LAUNCHES) == set(kernels.NAMES)
