"""Frozen copy of ``zeth_tpu_torch/zkp/fri.py`` (the FRI verifier and its
constants, numpy); the benchmark's yardstick, so it does not follow later
changes to the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import numpy as np

from .. import hostmath as H
from ..hash import merkle
from ..hostmath import P
from .transcript import Transcript


FRI_FOLD = 16
BLOWUP = 4
QUERIES = 50
FRI_MIN_DEGREE = 256
POW_BITS = 20       # Fiat-Shamir grinding before query sampling


@dataclass
class FriLayerOpening:
    row: np.ndarray     # (64,) standard-form base values of the group row
    path: np.ndarray    # (depth, 8) sibling digests


@dataclass
class FriProof:
    layer_roots: list       # list of (8,) digests
    final_coeffs: np.ndarray  # (d, 4) ext coefficients, standard form
    openings: list = dfield(default_factory=list)  # [query][layer] -> FriLayerOpening
    pow_nonce: int = 0      # grinding nonce (POW_BITS)


# ---------------------------------------------------------------------------
# Host verification
# ---------------------------------------------------------------------------


def _intt16_np(vals_ext: np.ndarray) -> np.ndarray:
    """Host 16-point ext iNTT (vals: (16, 4) standard form)."""
    w_inv = H.rou_rev(FRI_FOLD)
    out = np.zeros((FRI_FOLD, 4), dtype=np.uint64)
    for j in range(FRI_FOLD):
        acc = np.zeros(4, dtype=np.uint64)
        wj = H.powers(pow(w_inv, j, P), FRI_FOLD)
        for k in range(FRI_FOLD):
            acc = H.ext_add(acc, (vals_ext[k].astype(np.uint64) * wj[k]) % H.PU)
        out[j] = (acc * np.uint64(pow(FRI_FOLD, P - 2, P))) % H.PU
    return out


def verify(proof: FriProof, degree: int, shift: int, transcript: Transcript,
           inner) -> list[int]:
    """Replay the FRI transcript and check all query chains.

    inner(q) -> (4,) standard-form ext value of the committed polynomial at
    domain index q (computed by the caller from its own trace openings).
    Returns the query indices. Raises ValueError on any failure.
    """
    n0 = degree * BLOWUP
    # replay commit phase
    phis = []
    domains = []
    deg, cur_shift, n_l = int(degree), int(shift), n0
    li = 0
    while deg > FRI_MIN_DEGREE:
        transcript.mix(proof.layer_roots[li])
        phis.append(transcript.sample_ext())
        domains.append((n_l, cur_shift))
        cur_shift = pow(cur_shift, FRI_FOLD, P)
        n_l //= FRI_FOLD
        deg //= FRI_FOLD
        li += 1
    if li != len(proof.layer_roots):
        raise ValueError("fri: layer count mismatch")
    if proof.final_coeffs.shape[0] != deg:
        raise ValueError("fri: final degree mismatch")
    if proof.final_coeffs.ndim != 2 or proof.final_coeffs.shape[1] != 4:
        raise ValueError("fri: final coeff shape")
    transcript.mix_values(np.asarray(proof.final_coeffs, np.uint64).reshape(-1))
    if not transcript.check_grind(POW_BITS, proof.pow_nonce):
        raise ValueError("fri: proof-of-work grinding check failed")
    qs = [transcript.sample_index(n0) for _ in range(QUERIES)]
    if len(proof.openings) != len(qs):
        raise ValueError("fri: opening count mismatch")

    # batched Merkle verification: all queries per layer at once
    for ell in range(len(domains)):
        n_l = domains[ell][0]
        m = n_l // FRI_FOLD
        gl, rows_l, paths_l = [], [], []
        for qi, q in enumerate(qs):
            if len(proof.openings[qi]) != len(domains):
                raise ValueError("fri: layer opening count mismatch")
            pos = q
            for e2 in range(ell):
                pos = pos % (domains[e2][0] // FRI_FOLD)
            gl.append(pos % m)
            rows_l.append(np.asarray(proof.openings[qi][ell].row))
            paths_l.append(proof.openings[qi][ell].path)
        if not merkle.verify_many(proof.layer_roots[ell], gl, rows_l,
                                  paths_l, depth=m.bit_length() - 1,
                                  width=FRI_FOLD * 4):
            raise ValueError(f"fri: bad merkle path (layer {ell})")

    for qi, q in enumerate(qs):
        pos = q
        value = np.asarray(inner(q), dtype=np.uint64)
        if len(proof.openings[qi]) != len(domains):
            raise ValueError("fri: layer opening count mismatch")
        for ell, ((n_l, h_l), phi) in enumerate(zip(domains, phis)):
            opening = proof.openings[qi][ell]
            m = n_l // FRI_FOLD
            g = pos % m
            k = pos // m
            vals = opening.row.reshape(FRI_FOLD, 4)
            if not (vals[k] == value).all():
                raise ValueError(f"fri: layer value mismatch (query {qi} layer {ell})")
            u = _intt16_np(vals)
            x0 = int(h_l) * pow(H.rou_fwd(n_l), g, P) % P
            s = H.ext_mul(phi, H.ext(pow(x0, P - 2, P)))
            acc = u[0]
            powj = s
            for j in range(1, FRI_FOLD):
                acc = H.ext_add(acc, H.ext_mul(u[j], powj))
                if j + 1 < FRI_FOLD:
                    powj = H.ext_mul(powj, s)
            value = acc
            pos = g
        # final polynomial evaluation at the remaining position
        n_fin, h_fin = (domains[-1][0] // FRI_FOLD,
                        pow(domains[-1][1], FRI_FOLD, P)) if domains else (n0, shift)
        x = int(h_fin) * pow(H.rou_fwd(n_fin), pos, P) % P
        xp = H.powers(x, proof.final_coeffs.shape[0])
        want = np.zeros(4, dtype=np.uint64)
        for j in range(proof.final_coeffs.shape[0]):
            want = H.ext_add(want, (proof.final_coeffs[j] * xp[j]) % H.PU)
        if not (want == value).all():
            raise ValueError(f"fri: final polynomial mismatch (query {qi})")
    return qs
