"""Frozen copy of ``zeth_tpu_torch/zkp/verifier.py``: the STARK verifier,
host numpy, with the control group's root recomputed in plain torch on
`device` (no kernel); the benchmark's yardstick, so it does not follow
later changes to the program. The copy's only departures: the device is
passed in, never resolved, and the control root comes from
``stark.control_root``.

Replaces the verifier of risc0-zkp 3.0.2 (SURVEY.md §2.2). Mirrors the
prover's transcript (PROTOCOL.md) exactly; the "implement the verifier
first" oracle of SURVEY.md §7.2 step 6 — every prover change must keep
this verifier accepting.

Any proof whose control root differs from the recomputed one (cached per
(air, po2)) is rejected — the analog of the reference's known
code/control commitment.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import hostmath as H
from ..hostmath import GENERATOR, P
from ..hash import merkle
from . import fri
from .air import Air, HostExtOps
from .stark import (TAP_STREAMS, BLOWUP, StarkProof, all_challenges,
                    control_root, scalar_publics)
from .transcript import Transcript


class VerificationError(Exception):
    pass


@functools.lru_cache(maxsize=None)
def _expected_control_root(air_key, po2: int, device) -> tuple:
    """The control-group commitment of (air, po2), computed on `device`
    exactly as ``prover.prove`` commits the control group; cached."""
    air = _AIR_REGISTRY[air_key]
    return tuple(int(v) for v in control_root(air.control_trace(po2), device))


_AIR_REGISTRY: dict = {}


def _ensure(cond, msg):
    if not cond:
        raise VerificationError(msg)


def verify(air: Air, proof: StarkProof, publics: list[int],
           derived_extra=None, extra_mix=None, device="cpu") -> np.ndarray:
    """Raise VerificationError unless the proof is valid for (air, publics).

    device: where the control commitment is recomputed (a torch device);
    everything else runs on the host.

    derived_extra/extra_mix: companion-proof bindings, mirroring
    prover.prove (the caller is responsible for checking the companion
    proof binds these same values). Returns the sampled challenges
    ((n_challenges, 4) standard form) so callers can cross-check them
    against companion publics.

    Any structural malformation of an untrusted seal (wrong shapes,
    short arrays, bad counts) raises VerificationError too, never a bare
    IndexError/ValueError (ADVICE.md r1 finding #4).
    """
    try:
        return _verify_inner(air, proof, publics, derived_extra, extra_mix,
                             device)
    except VerificationError:
        raise
    except (IndexError, ValueError, KeyError, AssertionError, TypeError,
            AttributeError) as e:
        raise VerificationError(f"malformed proof: {type(e).__name__}: {e}") \
            from e


def _verify_inner(air: Air, proof: StarkProof, publics: list[int],
                  derived_extra, extra_mix, device) -> np.ndarray:
    n = 1 << proof.po2
    _ensure(isinstance(proof.po2, int) and 2 <= proof.po2 <= 27,
            "po2 out of range")
    _ensure(proof.air_name == air.name, "air name mismatch")
    _ensure([int(p) for p in proof.publics] == [int(p) for p in publics],
            "public values mismatch")
    for g, root in proof.roots.items():
        _ensure(np.asarray(root).shape == (8,), f"bad root shape: {g}")

    t = Transcript()
    t.mix_values(np.array([proof.po2] + [int(p) for p in publics],
                          dtype=np.uint64))

    # --- replay commits --------------------------------------------------
    _AIR_REGISTRY[air.name] = air
    if air.control_cols:
        want_root = np.array(
            _expected_control_root(air.name, proof.po2, device),
            dtype=np.uint64)
        _ensure((proof.roots["control"] == want_root).all(),
                "control root mismatch")
    t.mix(proof.roots["control"])
    t.mix(proof.roots["main"])
    if extra_mix is not None:
        t.mix(np.asarray(extra_mix, np.uint64).reshape(8))
    sampled = np.stack([t.sample_ext() for _ in range(air.n_challenges)]) \
        if air.n_challenges else np.zeros((0, 4), dtype=np.uint64)
    challenges = all_challenges(air, publics, sampled, derived_extra)
    if air.aux_cols:
        t.mix(proof.roots["aux"])
    alpha = t.sample_ext()
    t.mix(proof.roots["check"])
    z = t.sample_ext()

    # --- tap bookkeeping -------------------------------------------------
    sizes = {"control": air.control_cols, "main": air.main_cols,
             "aux": air.aux_cols, "check": 16}
    tap_slices = {}
    off = 0
    for (gname, offset) in TAP_STREAMS:
        c = sizes[gname]
        tap_slices[(gname, offset)] = slice(off, off + c)
        off += c
    _ensure(proof.taps.shape == (off, 4), "tap vector shape mismatch")
    taps = np.asarray(proof.taps, dtype=np.uint64)
    t.mix_values(taps.reshape(-1))

    # --- DEEP-ALI identity at z -----------------------------------------
    def tap(gname, col, offset=0):
        return taps[tap_slices[(gname, offset)]][col]

    def v(gname, col, offset=0):
        return tap(gname, col, offset)

    pubs_ops = [H.ext(int(p) % P) for p in scalar_publics(air, publics)]
    # challenges reach the AIR as 4-tuples of components, each embedded
    # into the DEEP field (circuit-ext algebra — see zkp.air.cmul)
    chals_ops = [tuple(H.ext(int(c[j]) % P) for j in range(4))
                 for c in challenges]
    cs = air.constraints(v, HostExtOps, pubs_ops, chals_ops)
    # sum_i alpha^i c_i, summed in one vectorized step
    c_at_z = H.ext_mul(H.ext_power_table(alpha, len(cs)),
                       np.stack([H.ext(c) for c in cs])).sum(axis=0) % H.PU
    z_n = H.ext_pow(z, n)
    z_inv = H.ext_inv(H.ext_sub(z_n, H.ext(1)))
    q_expected = H.ext_mul(c_at_z, z_inv)
    # reassemble Q(z) = sum_k z^(kn) sum_comp basis_comp * check_tap[4k+comp]
    q_claim = np.zeros(4, dtype=np.uint64)
    check_taps = taps[tap_slices[("check", 0)]]
    for k in range(BLOWUP):
        part = np.zeros(4, dtype=np.uint64)
        for comp in range(4):
            basis = np.zeros(4, dtype=np.uint64)
            basis[comp] = 1
            part = H.ext_add(part, H.ext_mul(basis, check_taps[4 * k + comp]))
        q_claim = H.ext_add(q_claim, H.ext_mul(H.ext_pow(z, k * n), part))
    _ensure((q_claim == q_expected).all(), "DEEP-ALI identity failed at z")

    # --- DEEP combination setup -----------------------------------------
    beta = t.sample_ext()
    n_z = air.control_cols + air.main_cols + air.aux_cols + 16
    n_zg = air.control_cols + air.main_cols + air.aux_cols
    beta_pows = H.ext_power_table(beta, n_z + n_zg)
    w_n = H.rou_fwd(n)
    zg = H.ext_mul(H.ext(z), H.ext(w_n))

    group_order_z = ["control", "main", "aux", "check"]
    group_order_zg = ["control", "main", "aux"]

    def inner(q):
        """f0(x_q) from the opened LDE rows at query q: per point, the
        beta-weighted sum over the columns of (f(x_q) - tap), each group's
        columns in one vectorized step."""
        qi = proof.query_indices.index(q)
        x = GENERATOR * pow(H.rou_fwd(BLOWUP * n), q, P) % P
        acc = np.zeros(4, dtype=np.uint64)
        for point, order, base in ((z, group_order_z, 0),
                                   (zg, group_order_zg, n_z)):
            num = np.zeros(4, dtype=np.uint64)
            j = 0
            for gname in order:
                c = sizes[gname]
                row = np.asarray(proof.openings[gname].rows[qi],
                                 dtype=np.uint64).reshape(-1)
                _ensure(row.shape[0] >= c, f"short opening row: {gname}")
                stream = tap_slices[(gname, 1 if base else 0)] \
                    if gname != "check" else tap_slices[("check", 0)]
                fx = np.zeros((c, 4), dtype=np.uint64)   # base -> ext
                fx[:, 0] = row[:c] % H.PU
                diff = H.ext_sub(fx, taps[stream][:c])
                num = (num + H.ext_mul(beta_pows[base + j:base + j + c],
                                       diff).sum(axis=0)) % H.PU
                j += c
            denom = H.ext_inv(H.ext_sub(H.ext(x), point))
            acc = H.ext_add(acc, H.ext_mul(num, denom))
        return acc

    # --- FRI verification (also replays queries) ------------------------
    try:
        qs = fri.verify(proof.fri_proof, n, GENERATOR, t, inner)
    except ValueError as e:
        raise VerificationError(f"fri: {e}") from e
    _ensure(qs == proof.query_indices, "query index mismatch")

    # --- Merkle openings of every group at every query ------------------
    # Path depth is pinned to log2(LDE rows) and row width to the exact
    # group column count, so inner nodes can't be opened as leaves.
    depth = proof.po2 + 2           # log2(BLOWUP * n)
    for gname in ("control", "main", "aux", "check"):
        if sizes[gname] == 0 or (gname == "aux" and air.aux_cols == 0):
            continue
        op = proof.openings[gname]
        _ensure(np.asarray(op.rows).shape == (len(qs), sizes[gname]),
                f"bad opening rows shape: group {gname}")
        _ensure(len(op.paths) == len(qs),
                f"bad opening path count: group {gname}")
        _ensure(
            merkle.verify_many(proof.roots[gname], qs, op.rows, op.paths,
                               depth=depth, width=sizes[gname]),
            f"bad merkle path: group {gname}")
    return sampled
