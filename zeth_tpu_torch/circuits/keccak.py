"""Keccak-f[1600] accelerator circuit: prove batches of permutations.

TPU-native replacement for risc0-circuit-keccak 4.0.2 (SURVEY.md §2.2):
the guest's keccak syscalls are recorded by the executor and proven here
as a standalone STARK, off the main rv32im trace — the reference's
accelerator-offload axis (§2.3).

Trace layout: each permutation occupies a 32-row block — rows 0..23 hold
the state at the start of each round, row 24 holds the output state,
rows 25..31 are zero padding. Columns (all bits):

  s[1600]   state A (lane-major: lane*64 + z)
  c[320]    theta column parities    (x*64 + z)
  w0,w1[320 each]  parity slack: sum_y s = c + 2*(w0 + 2*w1)
  t[1600]   theta output bits (after adding D)

Round function as constraints (degree <= 4):
  parity:   sum_y s[x,y,z] - c - 2w0 - 4w1 = 0             (+ bools on c,w)
  theta:    t = s XOR d,  d = c[x-1,z] XOR c[x+1,z-1]       (deg 3)
  chi+iota: s_next = chi(rho_pi(t)) XOR rc, gated by the control
            round-active column; the iota constant folds in via the
            precomputed control product column grc = active*rc so the
            gated constraint stays degree 4.
  s bits on input rows are booleanity-constrained; later rows inherit
  booleanity from the (boolean-valued) transition expressions.

v1 claim binding: the proof commits the permutation trace; the
(inputs -> outputs) claims digest is computed host-side from the same
trace (zeth_tpu.recursion resolve-machinery binding is a later round,
like the reference's assumption receipts).

Port note: a jax-free copy of ``zeth_tpu.circuits.keccak``. The AIR is
unchanged; ``prove_batch`` runs on the port's prover on `device` (None:
the CUDA card), and ``claims_digest`` hashes on `device` too. The
recursion hooks (``publics_shape``, ``derived_challenges_rec``), which
let ``recursion.succinct`` lift a batch proof into the root fold, come
from ``circuits.resolve``, shared with the bigint and sha AIRs.
"""

from __future__ import annotations

import numpy as np

from .. import hostmath as H
from ..convert import resolve_device
from ..hash import poseidon2 as P2
from ..hash.keccak import _PI_ROT, _PI_SRC, _RC
from ..zkp import proof as proof_mod
from ..zkp import prover as prover_mod
from ..zkp import verifier as verifier_mod
from ..zkp.air import Air
from .resolve import LimbStreamResolve

ROWS_PER_PERM = 32
ROUNDS = 24

# main column offsets
S_OFF = 0
C_OFF = 1600
W0_OFF = C_OFF + 320
W1_OFF = W0_OFF + 320
T_OFF = W1_OFF + 320
BA_COL = T_OFF + 1600        # blk_active: this 32-row block carries a
                             # claimed permutation (bound to the publics)
N_MAIN = BA_COL + 1

# control: is_input, rnd_active, grc[64] (= rnd_active * iota rc bit z),
# is_output (row 24 = final state), is_blk_last (row 31), is_first/last
CT_INPUT, CT_ACTIVE = 0, 1
CT_GRC = 2
CT_OUTPUT = CT_GRC + 64
CT_BLK_LAST = CT_OUTPUT + 1
CT_ISF = CT_BLK_LAST + 1
CT_ISL = CT_ISF + 1
N_CONTROL = CT_ISL + 1


def _s_col(lane: int, z: int) -> int:
    return S_OFF + lane * 64 + z


def _c_col(x: int, z: int) -> int:
    return C_OFF + x * 64 + z


def _t_col(lane: int, z: int) -> int:
    return T_OFF + lane * 64 + z


# chi reads b[x,y,z] where b[j] = rotl64(t[PI_SRC[j]], PI_ROT[j]):
# b[j] bit z = t[PI_SRC[j]] bit (z - PI_ROT[j]) mod 64
def _b_col(lane: int, z: int) -> int:
    return _t_col(int(_PI_SRC[lane]), (z - int(_PI_ROT[lane])) % 64)


class KeccakAir(LimbStreamResolve, Air):
    """Batch of keccak-f[1600] permutations, 32 rows each."""

    name = "keccak-f1600"
    control_cols = N_CONTROL
    main_cols = N_MAIN
    aux_cols = 4                  # one ext slot: the IO RLC chain
    n_challenges = 1              # gamma for the RLC
    n_derived = 1                 # expected RLC of the public IO limbs
    n_public_scalars = 0
    main_bit_mask = np.ones(N_MAIN, dtype=bool)

    def control_trace(self, po2: int) -> np.ndarray:
        n = 1 << po2
        cols = np.zeros((n, N_CONTROL), dtype=np.uint64)
        r = np.arange(n) % ROWS_PER_PERM
        cols[:, CT_INPUT] = r == 0
        cols[:, CT_ACTIVE] = r < ROUNDS
        for z in range(64):
            rc_bits = np.array([(_RC[int(rr)] >> z) & 1 if rr < ROUNDS else 0
                                for rr in r], dtype=np.uint64)
            cols[:, CT_GRC + z] = rc_bits * cols[:, CT_ACTIVE]
        cols[:, CT_OUTPUT] = r == ROUNDS
        cols[:, CT_BLK_LAST] = r == ROWS_PER_PERM - 1
        cols[0, CT_ISF] = 1
        cols[-1, CT_ISL] = 1
        return cols

    # -- IO binding --------------------------------------------------------

    def derived_challenges(self, publics, challenges, extra=None):
        words = parse_publics(publics)
        from .rv32im import _rlc
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        return _rlc(words, gamma)[None, :]

    def build_aux(self, main_std, challenges):
        main_std = np.asarray(main_std, np.uint64)
        n = main_std.shape[0]
        gamma = H.ext(np.asarray(challenges[0], np.uint64))
        g100 = H.ext_pow(gamma, 100)
        gp_rev = H.ext_powers(gamma, 100)[::-1]   # gamma^99 .. gamma^0
        # state limbs per row: (n, 100) from the 1600 s bits
        bits = main_std[:, S_OFF:S_OFF + 1600].reshape(n, 100, 16)
        weights = (np.uint64(1) << np.arange(16, dtype=np.uint64))
        limbs = (bits * weights[None, None, :]).sum(axis=2)
        r_mod = np.arange(n) % ROWS_PER_PERM
        absorb = ((r_mod == 0) | (r_mod == ROUNDS)) \
            & (main_std[:, BA_COL] == 1)
        col = np.zeros((n, 4), dtype=np.uint64)
        r = np.zeros(4, dtype=np.uint64)
        for i in np.nonzero(absorb)[0]:
            acc = ((gp_rev * limbs[i][:, None]) % H.PU).sum(axis=0) % H.PU
            r = H.ext_add(H.ext_mul(r, g100), acc)
            col[i:] = r
        return col

    # -- witgen ------------------------------------------------------------

    @staticmethod
    def witgen(states: np.ndarray, po2: int) -> tuple[np.ndarray, list]:
        """states: (nperm, 25) uint64 inputs -> (main_std (n, cols), publics).

        Replays the rounds in vectorized numpy, recording the per-round
        state/parity/theta bits. The publics carry the (input, output)
        word streams of the claimed (non-padding) permutations, bound
        in-circuit by the RLC chain.
        """
        n = 1 << po2
        n_real = states.shape[0]
        assert n_real * ROWS_PER_PERM <= n
        # pad with zero-state permutations so every 32-row block is a real
        # permutation (empty "active" rows would violate the iota constraint)
        full = n // ROWS_PER_PERM
        states = np.concatenate(
            [states, np.zeros((full - states.shape[0], 25), np.uint64)])
        nperm = full
        m = np.zeros((n, N_MAIN), dtype=np.uint8)
        for b in range(n_real):
            m[b * ROWS_PER_PERM:(b + 1) * ROWS_PER_PERM, BA_COL] = 1

        a = states.astype(np.uint64).copy()    # (p, 25)

        def put_bits(rows, off, lanes):
            """lanes: (p, k) uint64 -> 64 bit cols each at rows (p,)."""
            for li in range(lanes.shape[1]):
                for z in range(64):
                    m[rows, off + li * 64 + z] = \
                        (lanes[:, li] >> np.uint64(z)) & np.uint64(1)

        rot = lambda v, k: (v << np.uint64(k % 64)) | (v >> np.uint64(
            (64 - k) % 64)) if k % 64 else v

        # rounds 0..23 advance the state; row 24 (the output row) also gets
        # its parity/theta columns so the ungated constraints hold there
        for rnd in range(ROUNDS + 1):
            rows = np.arange(nperm) * ROWS_PER_PERM + rnd
            put_bits(rows, S_OFF, a)
            # theta parities + slack
            for x in range(5):
                for z in range(64):
                    s = sum(((a[:, x + 5 * y] >> np.uint64(z)) & np.uint64(1))
                            for y in range(5))
                    bit = s & np.uint64(1)
                    slack = (s - bit) >> np.uint64(1)      # 0..2
                    m[rows, _c_col(x, z)] = bit
                    m[rows, W0_OFF + x * 64 + z] = slack & np.uint64(1)
                    m[rows, W1_OFF + x * 64 + z] = slack >> np.uint64(1)
            # theta output
            cpar = np.zeros((nperm, 5), dtype=np.uint64)
            for x in range(5):
                cx = a[:, x] ^ a[:, x + 5] ^ a[:, x + 10] ^ a[:, x + 15] ^ a[:, x + 20]
                cpar[:, x] = cx
            d = np.zeros((nperm, 5), dtype=np.uint64)
            for x in range(5):
                d[:, x] = cpar[:, (x - 1) % 5] ^ rot(cpar[:, (x + 1) % 5], 1)
            t = a.copy()
            for lane in range(25):
                t[:, lane] ^= d[:, lane % 5]
            put_bits(rows, T_OFF, t)
            if rnd == ROUNDS:
                break
            # rho+pi, chi, iota -> next round state
            b = np.zeros_like(t)
            for j in range(25):
                b[:, j] = rot(t[:, int(_PI_SRC[j])], int(_PI_ROT[j]))
            nxt = np.zeros_like(b)
            for x in range(5):
                for y in range(5):
                    nxt[:, x + 5 * y] = b[:, x + 5 * y] ^ (
                        ~b[:, (x + 1) % 5 + 5 * y] & b[:, (x + 2) % 5 + 5 * y])
            nxt[:, 0] ^= np.uint64(_RC[rnd])
            a = nxt
        # publics: [n_real, then per real perm: 50 input words + 50 output
        # words, each as (lo16, hi16)] — word order = state memory order
        publics = [n_real]
        outs = a       # state after ROUNDS rounds
        for b in range(n_real):
            for lanes in (states[b], outs[b]):
                for lane in lanes:
                    for word in (int(lane) & 0xFFFFFFFF,
                                 (int(lane) >> 32) & 0xFFFFFFFF):
                        publics += [word & 0xFFFF, word >> 16]
        return m.astype(np.uint64), publics

    # -- constraints -------------------------------------------------------

    def constraints(self, v, ops, publics, challenges):
        from ..zkp.air import cadd, cext, cmul, cmul_base, csub
        add, sub, mul = ops.add, ops.sub, ops.mul
        one = ops.const(1)
        two = ops.const(2)
        cs = []

        def boolc(e):
            return mul(e, sub(e, one))

        is_input = v("control", CT_INPUT)
        active = v("control", CT_ACTIVE)
        is_output = v("control", CT_OUTPUT)
        blk_last = v("control", CT_BLK_LAST)
        isf = v("control", CT_ISF)
        isl = v("control", CT_ISL)
        not_last = sub(one, isl)
        ba = v("main", BA_COL)

        # --- IO RLC binding (challenge gamma; derived expected value) -----
        cs.append(boolc(ba))
        # blk_active is constant within each 32-row block
        cs.append(mul(sub(one, blk_last), sub(v("main", BA_COL, 1), ba)))

        gamma = challenges[0]
        d_rlc = challenges[1]
        gpow = [cext(ops, 1)]
        for _ in range(100):
            gpow.append(cmul(ops, gpow[-1], gamma))   # scalar-only: free

        def state_limb(j, off=0):
            acc = None
            for k in range(16):
                term = mul(ops.const(1 << k), v("main", S_OFF + 16 * j + k,
                                                off))
                acc = term if acc is None else add(acc, term)
            return acc

        def absorb_lin(off=0):
            acc = None
            for j in range(100):
                term = cmul_base(ops, gpow[99 - j], state_limb(j, off))
                acc = term if acc is None else cadd(ops, acc, term)
            return acc

        r = tuple(v("aux", c) for c in range(4))
        rn = tuple(v("aux", c, 1) for c in range(4))
        act = mul(ba, add(is_input, is_output))
        act_n = mul(v("main", BA_COL, 1),
                    add(v("control", CT_INPUT, 1), v("control", CT_OUTPUT, 1)))
        # row 0 is an input row: r(0) = act * L(0)
        first_val = cmul_base(ops, absorb_lin(), act)
        cs.extend(cmul_base(ops, csub(ops, r, first_val), isf))
        # transition: rn = act_n ? r*g^100 + L_n : r
        stepped = cadd(ops, cmul(ops, r, gpow[100]), absorb_lin(1))
        mix = cadd(ops, cmul_base(ops, csub(ops, rn, stepped), act_n),
                   cmul_base(ops, csub(ops, rn, r), sub(one, act_n)))
        cs.extend(cmul_base(ops, mix, not_last))
        # final value equals the host-derived RLC of the public IO
        cs.extend(cmul_base(ops, csub(ops, r, d_rlc), isl))

        # input-row state booleanity (later rows inherit from transitions)
        for j in range(1600):
            cs.append(mul(is_input, boolc(v("main", S_OFF + j))))
        # parity slack booleanity
        for off in (C_OFF, W0_OFF, W1_OFF):
            for j in range(320):
                cs.append(boolc(v("main", off + j)))
        # theta parity decomposition
        for x in range(5):
            for z in range(64):
                s = v("main", _s_col(x, z))
                for y in range(1, 5):
                    s = add(s, v("main", _s_col(x + 5 * y, z)))
                rhs = add(v("main", _c_col(x, z)),
                          add(mul(two, v("main", W0_OFF + x * 64 + z)),
                              mul(ops.const(4), v("main", W1_OFF + x * 64 + z))))
                cs.append(sub(s, rhs))
        # theta output: t = s xor d, d = c[x-1,z] xor c[x+1,z-1]
        for lane in range(25):
            x = lane % 5
            for z in range(64):
                c1 = v("main", _c_col((x - 1) % 5, z))
                c2 = v("main", _c_col((x + 1) % 5, (z - 1) % 64))
                d = sub(add(c1, c2), mul(two, mul(c1, c2)))
                s = v("main", _s_col(lane, z))
                want = sub(add(s, d), mul(two, mul(s, d)))
                cs.append(sub(v("main", _t_col(lane, z)), want))
        # chi + iota transition: next-row s = chi(rho_pi(t)) xor rc
        for x in range(5):
            for y in range(5):
                lane = x + 5 * y
                for z in range(64):
                    b0 = v("main", _b_col(lane, z))
                    b1 = v("main", _b_col((x + 1) % 5 + 5 * y, z))
                    b2 = v("main", _b_col((x + 2) % 5 + 5 * y, z))
                    u = mul(sub(one, b1), b2)
                    vexpr = add(b0, mul(u, sub(one, mul(two, b0))))
                    nxt = v("main", _s_col(lane, z), 1)
                    con = mul(active, sub(nxt, vexpr))
                    if lane == 0:
                        grc = v("control", CT_GRC + z)
                        con = sub(con, mul(grc, sub(one, mul(two, vexpr))))
                    cs.append(con)
        return cs


def parse_publics(pubs) -> list[int]:
    """Decode the public IO: flat 32-bit words (per claimed permutation:
    50 input words then 50 output words, state memory order)."""
    p = [int(x) for x in pubs]
    if not p:
        raise ValueError("empty keccak publics")
    n = p[0]
    if len(p) != 1 + 200 * n:
        raise ValueError("bad keccak publics length")
    return [p[1 + 2 * i] | (p[2 + 2 * i] << 16) for i in range(100 * n)]


def claims_digest(io_words: list[int], device=None) -> np.ndarray:
    """Poseidon2 digest over the proof-bound IO word stream (the
    reference's assumption claims digest role), hashed on `device` (None:
    the CUDA card)."""
    w = np.asarray(io_words, np.uint64)
    limbs = np.stack([w & 0xFFFF, w >> np.uint64(16)], axis=-1).reshape(-1)
    return P2.sponge_row(limbs, device)


def choose_po2(nperm: int) -> int:
    need = max(nperm * ROWS_PER_PERM, 64)
    return int(np.ceil(np.log2(need)))


def prove_batch(states: np.ndarray, device=None):
    """Prove a batch of keccak-f applications on `device` (None: the CUDA
    card; without one the call raises).

    Returns (seal, claims digest). The digest commits the (input, output)
    word streams, which are RLC-bound to the proven trace — a forged
    output no longer verifies (round-1 gap VERDICT weak #8)."""
    device = resolve_device(device)
    air = KeccakAir()
    po2 = choose_po2(states.shape[0])
    with prover_mod._Stage("keccak witgen (host)", device):
        main, publics = KeccakAir.witgen(states, po2)
    pf = prover_mod.prove(air, main, publics, device=device)
    with prover_mod._Stage("claims digest", device):
        digest = claims_digest(parse_publics(publics), device)
    return proof_mod.encode(pf), digest


def verify_batch(seal, device=None) -> list[int]:
    """Verify an accelerator seal (the control root on `device`, None: the
    CUDA card); returns the proof-bound IO words (per perm: 50 input + 50
    output). The caller links them to the rv32im segments' keccak IO lists
    (the resolve step)."""
    pf = proof_mod.decode(seal)
    verifier_mod.verify(KeccakAir(), pf, pf.publics, device=device)
    return parse_publics(pf.publics)
