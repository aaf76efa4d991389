"""zeth_tpu_torch.hash.poseidon2 against zeth_tpu's Poseidon2.

The constants, the device permutation, the plain leaf sponge and the pair
compression must equal the JAX package's device functions and its numpy
ground truth. The plain leaf sponge against the TPU leaf kernel is in
tests/test_torch_leaf_pallas.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeth_tpu import field as JF
from zeth_tpu.hash import poseidon2 as JP2
from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch.convert import to_numpy
from zeth_tpu_torch.convert import to_tensor as _to_tensor
from zeth_tpu_torch.hash import poseidon2 as TP2

torch.set_num_threads(2)


def to_tensor(a):
    """The tests run on the CPU; the port's default device is the card."""
    return _to_tensor(a, device="cpu")


def _monty(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, H.P, size=shape, dtype=np.uint32)


def test_constants_equal_reference():
    want, got = JP2._monty_constants(), TP2._monty_constants()
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for k, v in JP2.constants().items():
        np.testing.assert_array_equal(TP2.constants()[k], v)
    assert TP2.PAIR_TAG == JP2.PAIR_TAG


def test_permute_equals_reference_and_host():
    st = _monty(1, (24, 96))
    st[:, 0] = 0
    got = TP2.permute(to_tensor(st))
    np.testing.assert_array_equal(to_numpy(got),
                                  np.asarray(JP2.permute(jnp.asarray(st))))
    want_std = JP2.permute_np(H.from_monty_np(st))
    np.testing.assert_array_equal(H.from_monty_np(to_numpy(got)), want_std)
    np.testing.assert_array_equal(TP2.permute_np(H.from_monty_np(st)),
                                  want_std)


# the last two are the TPU leaf kernel's tile-sized shapes of
# tests/test_pallas.py, which holds that kernel equal to the same sponge
@pytest.mark.parametrize("n,k", [(1, 1), (5, 3), (8, 16), (33, 37), (4, 100),
                                 (1024, 5), (2048, 100)])
def test_hash_rows_equals_host(n, k):
    rows = _monty(2 + k, (n, k))
    got = TP2.hash_rows(to_tensor(rows))
    assert got.shape == (n, 8) and got.dtype == torch.int32
    want_std = JP2.hash_rows_np(H.from_monty_np(rows))
    np.testing.assert_array_equal(H.from_monty_np(to_numpy(got)), want_std)
    np.testing.assert_array_equal(TP2.hash_rows_np(H.from_monty_np(rows)),
                                  want_std)


def test_hash_rows_equals_reference_device_function():
    # one shape: every shape is a separate XLA compile on the CPU
    rows = _monty(2, (33, 37))
    np.testing.assert_array_equal(
        to_numpy(TP2.hash_rows(to_tensor(rows))),
        np.asarray(JP2.hash_rows(jnp.asarray(rows))))


def test_hash_pairs_equals_reference_and_host():
    left, right = _monty(3, (70, 8)), _monty(4, (70, 8))
    got = TP2.hash_pairs(to_tensor(left), to_tensor(right))
    np.testing.assert_array_equal(
        to_numpy(got),
        np.asarray(JP2.hash_pairs(jnp.asarray(left), jnp.asarray(right))))
    want_std = JP2.hash_pairs_np(H.from_monty_np(left),
                                 H.from_monty_np(right))
    np.testing.assert_array_equal(H.from_monty_np(to_numpy(got)), want_std)
    np.testing.assert_array_equal(
        TP2.hash_pairs_np(H.from_monty_np(left), H.from_monty_np(right)),
        want_std)


def test_leaf_hash_on_cpu_is_the_plain_sponge():
    rows = to_tensor(_monty(6, (12, 19)))
    assert torch.equal(TP2.leaf_hash(rows), TP2.hash_rows(rows))


def test_leaf_hash_rejects_other_devices():
    with pytest.raises(ValueError):
        TP2.leaf_hash(torch.zeros((4, 4), dtype=torch.int32, device="meta"))


def test_montgomery_helpers_match_reference():
    a = _monty(7, (64,))
    np.testing.assert_array_equal(
        H.to_monty_np(H.from_monty_np(a)), a)
    np.testing.assert_array_equal(
        H.from_monty_np(a), np.asarray(JF.from_monty(jnp.asarray(a)),
                                       np.uint64))
