"""Toy AIRs: small circuits that exercise the full DEEP-ALI + FRI pipeline.

These are the build-order oracles of SURVEY.md §7.2 step 6 (prove a toy
AIR end-to-end before the rv32im circuit): boundary constraints via
control columns, transition constraints with next-row taps, and an aux
grand-product group consuming Fiat-Shamir challenges.

Jax-free copy of ``zeth_tpu.circuits.toy``.
"""

from __future__ import annotations

import numpy as np

from ..hostmath import P
from ..zkp.air import Air, is_first_column, is_last_column


class SquareChainAir(Air):
    """x_{i+1} = x_i^2; publics = [x_0, x_{n-1}].

    Exercises: control selectors, next-row taps, public-value binding.
    """

    name = "toy-square-chain"
    control_cols = 2     # [is_first, is_last]
    main_cols = 1

    def control_trace(self, po2: int) -> np.ndarray:
        return np.stack([is_first_column(po2), is_last_column(po2)], axis=1)

    def constraints(self, v, ops, publics, challenges):
        x = v("main", 0, 0)
        xn = v("main", 0, 1)
        isf = v("control", 0)
        isl = v("control", 1)
        one = ops.const(1)
        return [
            ops.mul(isf, ops.sub(x, publics[0])),
            ops.mul(ops.sub(one, isl), ops.sub(xn, ops.mul(x, x))),
            ops.mul(isl, ops.sub(x, publics[1])),
        ]

    @staticmethod
    def witgen(po2: int, x0: int):
        """Returns (main_std (n,1), publics)."""
        n = 1 << po2
        xs = np.empty(n, dtype=np.uint64)
        cur = x0 % P
        for i in range(n):
            xs[i] = cur
            cur = cur * cur % P
        return xs[:, None], [int(xs[0]), int(xs[-1])]


class PermutationAir(Air):
    """Column b is a permutation of column a (grand-product argument).

    Exercises: aux group witgen with post-commit challenges, associative
    scan on device, degree-3 transition constraints.
    """

    name = "toy-permutation"
    control_cols = 2     # [is_first, is_last]
    main_cols = 2        # [a, b]
    aux_cols = 1         # running product z of (a+gamma)/(b+gamma)
    n_challenges = 1

    def control_trace(self, po2: int) -> np.ndarray:
        return np.stack([is_first_column(po2), is_last_column(po2)], axis=1)

    def build_aux(self, main_std, challenges):
        from .. import hostmath as H
        gamma = np.uint64(int(challenges[0][0]) % P)
        a = np.asarray(main_std[:, 0], np.uint64)
        b = np.asarray(main_std[:, 1], np.uint64)
        ratio = H.fmul(H.fadd(a, gamma), H.fbatch_inv(H.fadd(b, gamma)))
        z = np.empty_like(ratio)
        acc = np.uint64(1)
        for i in range(ratio.shape[0]):
            acc = acc * ratio[i] % H.PU
            z[i] = acc
        return z[:, None]

    def constraints(self, v, ops, publics, challenges):
        gamma = challenges[0][0]    # toy: component 0 of the ext challenge
        a, b = v("main", 0), v("main", 1)
        an, bn = v("main", 0, 1), v("main", 1, 1)
        z, zn = v("aux", 0), v("aux", 0, 1)
        isf = v("control", 0)
        isl = v("control", 1)
        one = ops.const(1)
        return [
            ops.mul(isf, ops.sub(ops.mul(z, ops.add(b, gamma)),
                                 ops.add(a, gamma))),
            ops.mul(ops.sub(one, isl),
                    ops.sub(ops.mul(zn, ops.add(bn, gamma)),
                            ops.mul(z, ops.add(an, gamma)))),
            ops.mul(isl, ops.sub(z, one)),
        ]

    @staticmethod
    def witgen(po2: int, seed: int = 0):
        n = 1 << po2
        rng = np.random.default_rng(seed)
        a = rng.integers(0, P, size=n, dtype=np.uint64)
        b = rng.permutation(a)
        return np.stack([a, b], axis=1), []
