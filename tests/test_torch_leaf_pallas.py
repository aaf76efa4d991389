"""The plain Poseidon2 leaf sponge against the TPU leaf kernel.

``zeth_tpu_torch.hash.poseidon2.hash_rows`` is the plain version of the
CUDA leaf kernel (kernels/csrc/poseidon2_leaf.cu). It must equal
``zeth_tpu.pallas.poseidon2.hash_rows``, the TPU kernel it replaces, run
in Pallas interpret mode as tests/test_pallas.py runs it on the CPU.
Each kernel specialisation costs an interpret compile of some 20 s, so
one shape is checked here: the rv32im main group's 1009 columns, which
take two 512-column slabs (the first absorb and the last one, the sponge
state carried between them, the last chunk ragged). The single-slab
absorb of narrower matrices is held by two links: tests/test_pallas.py
holds the kernel equal to zeth_tpu's XLA hash_rows at (1024, 5),
(1024, 16) and (2048, 37), and test_torch_poseidon2 holds the plain
version equal to that function and to the numpy sponge.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch.convert import to_numpy
from zeth_tpu_torch.convert import to_tensor as _to_tensor
from zeth_tpu_torch.hash import poseidon2 as TP2

torch.set_num_threads(2)


def to_tensor(a):
    """The tests run on the CPU; the port's default device is the card."""
    return _to_tensor(a, device="cpu")


@pytest.mark.parametrize("r,c", [(1024, 1009)])
def test_plain_leaf_equals_pallas_kernel(monkeypatch, r, c):
    from zeth_tpu.pallas import poseidon2 as PP
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(5 + c)
    rows = rng.integers(0, H.P, size=(r, c), dtype=np.uint32)
    want = np.asarray(PP.hash_rows(jnp.asarray(rows)))
    got = TP2.hash_rows(to_tensor(rows))
    np.testing.assert_array_equal(to_numpy(got), want)
