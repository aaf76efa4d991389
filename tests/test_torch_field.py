"""zeth_tpu_torch.field against zeth_tpu.field, element for element.

Both packages get the same seeded numpy inputs (values below p, with 0,
1, p-1 and p-2 always among them); the port's int32 tensors must hold
the reference's uint32 arrays bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeth_tpu import field as JF
from zeth_tpu_torch import field as TF
from zeth_tpu_torch.convert import to_numpy
from zeth_tpu_torch.convert import to_tensor as _to_tensor
from zeth_tpu_torch.hostmath import P

torch.set_num_threads(2)


def to_tensor(a):
    """The tests run on the CPU; the port's default device is the card."""
    return _to_tensor(a, device="cpu")

EDGES = np.array([0, 1, P - 1, P - 2], dtype=np.uint32)


def _vals(seed: int, shape=(1024,)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=shape, dtype=np.uint32)
    flat = v.reshape(-1)
    flat[:len(EDGES)] = EDGES
    return v


def _pair(seed: int, shape=(1024,)):
    """Two operands that also cover every pairing of the edge values."""
    a, b = _vals(seed, shape), _vals(seed + 100, shape)
    fa, fb = a.reshape(-1), b.reshape(-1)
    k = len(EDGES)
    fa[k:k + k * k] = np.repeat(EDGES, k)
    fb[k:k + k * k] = np.tile(EDGES, k)
    return a, b


def _same(want, got):
    want = np.asarray(want, dtype=np.uint32)
    got = to_numpy(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mul", "add", "sub"])
def test_binary(name):
    a, b = _pair(1)
    want = getattr(JF, name)(jnp.asarray(a), jnp.asarray(b))
    _same(want, getattr(TF, name)(to_tensor(a), to_tensor(b)))


@pytest.mark.parametrize("name", ["neg", "to_monty", "from_monty", "inv"])
def test_unary(name):
    a = _vals(2)
    want = getattr(JF, name)(jnp.asarray(a))
    _same(want, getattr(TF, name)(to_tensor(a)))


@pytest.mark.parametrize("e", [0, 1, 2, 7, 1 << 20, P - 2])
def test_pow_const(e):
    a = _vals(3, (256,))
    _same(JF.pow_const(jnp.asarray(a), e), TF.pow_const(to_tensor(a), e))


def test_mul_std_is_montgomery_product_with_standard_scalar():
    a, s = _pair(4)
    want = JF.mul(jnp.asarray(a), JF.to_monty(jnp.asarray(s)))
    _same(want, TF.mul_std(to_tensor(a), to_tensor(s)))


@pytest.mark.parametrize("name", ["ext_mul", "ext_add", "ext_sub"])
def test_ext_binary(name):
    a, b = _pair(5, (256, 4))
    want = getattr(JF, name)(jnp.asarray(a), jnp.asarray(b))
    _same(want, getattr(TF, name)(to_tensor(a), to_tensor(b)))


def test_ext_inv():
    a = _vals(6, (256, 4))
    a[0] = [JF.R, 0, 0, 0]                  # one
    a[1] = [0, 0, 0, 0]                     # zero maps to zero
    want = JF.ext_inv(jnp.asarray(a))
    got = TF.ext_inv(to_tensor(a))
    _same(want, got)
    # a * a^-1 = 1 away from zero
    one = TF.ext_mul(to_tensor(a[2:]), got[2:])
    _same(np.tile(np.array([JF.R, 0, 0, 0], np.uint32), (254, 1)), one)


@pytest.mark.parametrize("e", [0, 1, 5, 1 << 20, 123456789])
def test_ext_pow_const(e):
    a = _vals(7, (64, 4))
    _same(JF.ext_pow_const(jnp.asarray(a), e),
          TF.ext_pow_const(to_tensor(a), e))


def test_ext_from_base_and_mul_base():
    a = _vals(8, (256, 4))
    s = _vals(9, (256,))
    _same(JF.ext_from_base(jnp.asarray(s)), TF.ext_from_base(to_tensor(s)))
    _same(JF.ext_mul_base(jnp.asarray(a), jnp.asarray(s)),
          TF.ext_mul_base(to_tensor(a), to_tensor(s)))


def test_constants_match():
    for name in ("P", "R", "BETA", "ROU_FWD", "ROU_REV"):
        assert getattr(TF, name) == getattr(JF, name), name
    assert TF.RINV * (1 << 32) % P == 1
    assert TF.mont_one() == JF.mont_one()
    for n in (1, 2, 1 << 10, 1 << 27):
        assert TF.ROU_FWD[n.bit_length() - 1] == JF.rou_fwd(n)


def test_convert_roundtrip():
    a = _vals(10, (33, 7))
    t = to_tensor(a)
    assert t.dtype == torch.int32 and t.shape == (33, 7)
    np.testing.assert_array_equal(to_numpy(t), a)
    with pytest.raises(ValueError):
        to_tensor(np.array([P], np.uint64))
