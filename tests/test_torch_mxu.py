"""zeth_tpu_torch.mxu and the prover's use of it against zeth_tpu.

The same seeded numpy inputs go through ``zeth_tpu.mxu`` (JAX on the CPU)
and ``zeth_tpu_torch.mxu`` (torch on the CPU, the same ``torch._int_mm``
products the card runs); every result must be equal bit for bit: the
field products (random operands, operands whose low digits are all -128,
a contraction longer than ``_MAX_K``), the four-step NTT both ways, the
four-step coset LDE (one column block, and a tail block), the plain
product, and the streamed main group's query rows. The four-step LDE
must also give the prover's radix-2 ``_lde`` words.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeth_tpu import mxu as JM
from zeth_tpu.zkp import prover as JP
from zeth_tpu_torch import field as TF
from zeth_tpu_torch import hostmath as TH
from zeth_tpu_torch import mxu as TM
from zeth_tpu_torch import ntt as TN
from zeth_tpu_torch.hostmath import P
from zeth_tpu_torch.zkp import prover as TP

torch.set_num_threads(2)

# 0x7F7F80 splits into the digits (-128, -128, -128, 1): every digit
# product of two such columns is 2^14, the largest there is
ALL_M128 = 0x7F7F80


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(
        0, P, size=shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32)
                            .view(np.int32).copy())


def _np(t):
    return t.contiguous().numpy().view(np.uint32)


def _monty(a):
    return TH.to_monty_np(np.asarray(a, np.uint64))


def test_digits_recombine_to_the_value():
    x = np.concatenate([_rand((999,), 1),
                        np.array([0, 1, 127, 128, 255, 256, ALL_M128, P - 1],
                                 np.uint32)])
    d = [v.numpy().astype(np.int64) for v in TM._digits_i8(_t(x))]
    assert all(((v >= -128) & (v <= 127)).all() for v in d)
    assert (sum(v << (8 * i) for i, v in enumerate(d)) == x).all()
    assert [int(v[-2]) for v in d] == [-128, -128, -128, 1]


@pytest.mark.parametrize("case", ["random", "all_m128_long_k"])
def test_modmm_and_modmm_tn_equal_reference(case):
    if case == "random":
        a, b = _monty(_rand((33, 300), 2)), _rand((300, 5), 3).astype(np.uint64)
    else:
        # k > _MAX_K forces the chunked sum; the partial sums of these
        # digit columns exceed int32, so both packages reduce the same
        # wrapped accumulator
        k = TM._MAX_K + 512
        a = np.full((3, k), ALL_M128, np.uint64)
        b = np.full((k, 2), ALL_M128, np.uint64)
        b[::5, 1] = _rand(b[::5, 1].shape, 4)
    a32, b32 = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    want = np.asarray(JM.modmm(jnp.asarray(a32), jnp.asarray(b32)))
    np.testing.assert_array_equal(_np(TM.modmm(_t(a32), _t(b32))), want)
    at = np.ascontiguousarray(a32.T)
    want_tn = np.asarray(JM.modmm_tn(jnp.asarray(at), jnp.asarray(b32)))
    np.testing.assert_array_equal(want_tn, want)
    np.testing.assert_array_equal(_np(TM.modmm_tn(_t(at), _t(b32))), want)


@pytest.mark.parametrize("shape", [(33, 300, 5), (7, TM._MAX_K + 40, 3)])
def test_modmm_equals_plain(shape):
    m, k, n = shape
    a, b = _t(_rand((m, k), 5)), _t(_rand((k, n), 6))
    np.testing.assert_array_equal(_np(TM.modmm(a, b)),
                                  _np(TM.modmm_plain(a, b)))
    # the plain product is the integer dot mod p
    want = (_rand((m, k), 5).astype(object) @ _rand((k, n), 6).astype(object)) % P
    np.testing.assert_array_equal(_np(TM.modmm_plain(a, b)),
                                  want.astype(np.uint32))


def test_ntt_fs_equals_reference():
    x = _monty(_rand((1 << 15, 8), 7))
    xt = _t(x)
    for inverse in (False, True):
        want = np.asarray(JM.ntt_fs(jnp.asarray(x), inverse=inverse))
        got = _np(TM.ntt_fs(xt, inverse=inverse))
        np.testing.assert_array_equal(got, want)
        radix2 = TN.intt(xt) if inverse else TN.ntt(xt)
        np.testing.assert_array_equal(got, _np(radix2))


@pytest.mark.parametrize("shape", [(1 << 15, 8), (64, TM.FS_COL_BLOCK + 17)])
def test_coset_lde_fs_equals_reference(shape):
    x = _monty(_rand(shape, 8))
    got = _np(TM.coset_lde_fs(_t(x)))
    np.testing.assert_array_equal(got, np.asarray(JM.coset_lde_fs(
        jnp.asarray(x))))
    np.testing.assert_array_equal(got, _np(TN.coset_lde(_t(x))))


@pytest.mark.parametrize("std", [True, False])
def test_coset_lde_fs_equals_prover_lde(std):
    """The four-step LDE gives the prover's radix-2 ``_lde`` words, from
    a standard-form group (the control and main uploads) and from a
    Montgomery one (the aux and check groups)."""
    x = _t(_rand((1 << 15, 3), 9))
    m = TF.to_monty(x) if std else x
    np.testing.assert_array_equal(_np(TM.coset_lde_fs(m)),
                                  _np(TP._lde(x, std=std)))


def test_eval_rows_at_points_equals_reference(monkeypatch):
    n, c = 1 << 10, 5
    coeffs = _monty(_rand((n, c), 10))
    w4n = TH.rou_fwd(4 * n)
    qs = [0, 1, 6, 1023, 2050, 4095, 3001]
    pts_m = _monty(np.array([pow(w4n, q, P) for q in qs], np.uint64))
    want = np.asarray(JP._eval_rows_at_points(jnp.asarray(coeffs),
                                              jnp.asarray(pts_m), n))
    got = TP._eval_rows_at_points(_t(coeffs), _t(pts_m), n)
    np.testing.assert_array_equal(_np(got), want)
    # the rows are the LDE's rows at those indices (coset 31 * <w_4n>)
    lde = TP._lde(_t(coeffs), std=False)
    shifted = TP._shifted_coeffs(TF.from_monty(_t(coeffs)))
    np.testing.assert_array_equal(
        _np(TP._eval_rows_at_points(shifted, _t(pts_m), n)),
        _np(lde[torch.tensor(qs)]))
    # power rows in several blocks of several chunks: the same words
    monkeypatch.setattr(TM, "_MAX_K", 16)
    np.testing.assert_array_equal(
        _np(TP._eval_rows_at_points(_t(coeffs), _t(pts_m), n)), want)
