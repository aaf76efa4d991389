"""zeth_tpu_torch's NTT/LDE and Merkle trees against zeth_tpu's.

The same seeded Montgomery inputs go through both packages: the
transforms must agree element for element, the Merkle roots and opened
paths must be equal, and the reference's host verifier must accept the
port's openings.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeth_tpu import ntt as JN
from zeth_tpu.hash import merkle as JM
from zeth_tpu.hash import poseidon2 as JP2
from zeth_tpu_torch import hostmath as H
from zeth_tpu_torch import ntt as TN
from zeth_tpu_torch.convert import to_numpy
from zeth_tpu_torch.convert import to_tensor as _to_tensor
from zeth_tpu_torch.hash import merkle as TM

torch.set_num_threads(2)


def to_tensor(a):
    """The tests run on the CPU; the port's default device is the card."""
    return _to_tensor(a, device="cpu")


def _monty(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, H.P, size=shape, dtype=np.uint32)


SHAPES = [(2,), (16, 3), (256, 5)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["ntt", "intt"])
def test_transform_equals_reference(name, shape):
    x = _monty(len(shape) + shape[0], shape)
    want = np.asarray(getattr(JN, name)(jnp.asarray(x)))
    got = getattr(TN, name)(to_tensor(x))
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_coset_lde_equals_reference(shape):
    x = _monty(7 + shape[0], shape)
    want = np.asarray(JN.coset_lde(jnp.asarray(x)))
    got = TN.coset_lde(to_tensor(x))
    assert got.shape == (4 * shape[0],) + shape[1:]
    np.testing.assert_array_equal(to_numpy(got), want)


def test_intt_inverts_ntt_and_bitrev_matches():
    x = to_tensor(_monty(3, (64, 2)))
    assert torch.equal(TN.intt(TN.ntt(x)), x)
    np.testing.assert_array_equal(TN.bitrev_perm(64), JN.bitrev_perm(64))
    np.testing.assert_array_equal(TN.coset_points(64), JN.coset_points(64))


def test_modsum_and_eval_poly_ext_equal_reference():
    c = _monty(4, (32, 3))
    zp = _monty(5, (32, 4))
    np.testing.assert_array_equal(to_numpy(TN.modsum(to_tensor(c))),
                                  np.asarray(JN.modsum(jnp.asarray(c))))
    np.testing.assert_array_equal(
        to_numpy(TN.eval_poly_ext(to_tensor(c), to_tensor(zp))),
        np.asarray(JN.eval_poly_ext(jnp.asarray(c), jnp.asarray(zp))))


def _check_openings(tt, m, idx):
    rows, cols = m.shape
    got = tt.open_many(idx)
    depth = len(tt.layers) - 1
    std_rows = H.from_monty_np(m[idx])
    assert JM.verify_many(tt.root, idx, std_rows, got, depth, cols)
    assert TM.verify_many(tt.root, idx, std_rows, got, depth, cols)
    assert JM.verify_path(tt.root, idx[2], std_rows[2], got[2], depth, cols)
    assert TM.verify_path(tt.root, idx[2], std_rows[2], got[2], depth, cols)
    # a wrong row is rejected by both verifiers
    bad = std_rows.copy()
    bad[1, 0] = (bad[1, 0] + 1) % H.P
    assert not JM.verify_many(tt.root, idx, bad, got, depth, cols)
    assert not TM.verify_many(tt.root, idx, bad, got, depth, cols)
    return got


def test_merkle_root_and_paths_equal_reference():
    # 64 rows: the whole tree above the leaves finishes on the host
    m = _monty(101, (64, 37))
    jt = JM.commit_rows(jnp.asarray(m))
    tt = TM.commit_rows(to_tensor(m))
    np.testing.assert_array_equal(tt.root, jt.root)
    assert len(tt.layers) == len(jt.layers)
    idx = [0, 1, 5, 63, 32]
    for g, w in zip(_check_openings(tt, m, idx), jt.open_many(idx)):
        np.testing.assert_array_equal(g, w)


def test_merkle_device_level_equals_host_ground_truth():
    # 2048 rows: one pair level is hashed on the device before the host
    # finishes (HOST_LEVELS_AT = 1024). The reference's numpy ground truth
    # stands in for its device build (one XLA compile per tree size).
    m = _monty(102, (2048, 3))
    tt = TM.commit_rows(to_tensor(m))
    level = JP2.hash_rows_np(H.from_monty_np(m))
    for lay in reversed(tt.layers):
        np.testing.assert_array_equal(_std(lay), level)
        if level.shape[0] > 1:
            level = JP2.hash_pairs_np(level[0::2], level[1::2])
    np.testing.assert_array_equal(tt.root, level[0])
    _check_openings(tt, m, [0, 1, 5, 2047, 1024])


def _std(layer):
    if isinstance(layer, torch.Tensor):
        layer = to_numpy(layer)
    return H.from_monty_np(layer)


def test_commit_digests_equals_reference():
    d = _monty(9, (16, 8))
    np.testing.assert_array_equal(TM.commit_digests(to_tensor(d)).root,
                                  JM.commit_digests(jnp.asarray(d)).root)
