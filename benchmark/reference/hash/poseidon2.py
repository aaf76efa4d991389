"""Frozen copy of ``zeth_tpu_torch/hash/poseidon2.py`` (the Poseidon2
permutation and sponge: numpy on the host, plain torch on a device; no
kernel); the benchmark's yardstick, so it does not follow later changes
to the program. The copy's one departure: ``constants`` is cached (the
program derives it anew on every host permutation); the values are the
same.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from .. import hostmath as H
from ..hostmath import P, RINV, R


CELLS = 24          # permutation width t
RATE = 16           # sponge rate
CAPACITY = 8        # sponge capacity
DIGEST_LEN = 8      # digest = first 8 cells
ROUNDS_FULL = 8     # external rounds (4 + 4)
ROUNDS_PARTIAL = 21 # internal rounds
SBOX_EXP = 7        # gcd(7, p-1) = 1

# The public Poseidon2 4x4 building block (Poseidon2 paper, §5.1).
_M4 = np.array(
    [[5, 7, 1, 3],
     [4, 6, 1, 1],
     [1, 3, 5, 7],
     [1, 1, 4, 6]], dtype=np.uint64)


def _derive(tag: str, count: int) -> list[int]:
    """Deterministic field elements: SHA-256("zeth-tpu:poseidon2:<tag>:<ctr>")."""
    out: list[int] = []
    ctr = 0
    while len(out) < count:
        h = hashlib.sha256(f"zeth-tpu:poseidon2:babybear:{tag}:{ctr}".encode()).digest()
        for i in range(0, 32, 4):
            v = int.from_bytes(h[i:i + 4], "little") & 0x7FFFFFFF
            if v < P and len(out) < count:
                out.append(v)
        ctr += 1
    return out


def _mat_det_mod_p(m: np.ndarray) -> int:
    """Determinant mod p via fraction-free Gaussian elimination (python ints)."""
    a = [[int(x) % P for x in row] for row in m]
    n = len(a)
    det = 1
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r][col] % P), None)
        if piv is None:
            return 0
        if piv != col:
            a[col], a[piv] = a[piv], a[col]
            det = P - det
        det = det * a[col][col] % P
        inv = pow(a[col][col], P - 2, P)
        for r in range(col + 1, n):
            f = a[r][col] * inv % P
            for c in range(col, n):
                a[r][c] = (a[r][c] - f * a[col][c]) % P
    return det


@functools.lru_cache(maxsize=1)
def constants() -> dict:
    """Round constants + internal diagonal (standard form, host ints)."""
    rc_ext = np.array(_derive("rc-external", ROUNDS_FULL * CELLS),
                      dtype=np.uint64).reshape(ROUNDS_FULL, CELLS)
    rc_int = np.array(_derive("rc-internal", ROUNDS_PARTIAL), dtype=np.uint64)
    # Internal diagonal: rejection-resample until M_I = J + diag(mu-1) is
    # invertible and the mu_i are pairwise distinct and nonzero.
    salt = 0
    while True:
        mu = _derive(f"int-diag:{salt}", CELLS)
        if len(set(mu)) == CELLS and all(m not in (0, 1) for m in mu):
            m_i = np.ones((CELLS, CELLS), dtype=np.uint64)
            for i, m in enumerate(mu):
                m_i[i, i] = m
            if _mat_det_mod_p(m_i) != 0:
                break
        salt += 1
    return {
        "rc_ext": rc_ext,
        "rc_int": rc_int,
        "diag": np.array(mu, dtype=np.uint64),
    }


@functools.lru_cache(maxsize=1)
def _monty_constants() -> dict:
    c = constants()
    return {
        "rc_ext": H.to_monty_np(c["rc_ext"]),
        "rc_int": H.to_monty_np(c["rc_int"]),
        "diag_m1": H.to_monty_np((c["diag"] - 1) % P),
    }


# ---------------------------------------------------------------------------
# Host ground truth (numpy uint64, standard form)
# ---------------------------------------------------------------------------


def _m4_block_np(x: np.ndarray) -> np.ndarray:
    """Apply M4 to each 4-cell block. x: (24, ...)."""
    out = np.empty_like(x)
    for b in range(CELLS // 4):
        blk = x[4 * b:4 * b + 4]
        out[4 * b:4 * b + 4] = np.tensordot(_M4, blk, axes=(1, 0)) % H.PU
    return out


def _external_np(x: np.ndarray) -> np.ndarray:
    """M_E = circ(2*M4, M4, ...): per-block M4, then add the block-sum."""
    z = _m4_block_np(x)
    s = np.zeros((4,) + x.shape[1:], dtype=np.uint64)
    for b in range(CELLS // 4):
        s = (s + z[4 * b:4 * b + 4]) % H.PU
    for b in range(CELLS // 4):
        z[4 * b:4 * b + 4] = (z[4 * b:4 * b + 4] + s) % H.PU
    return z


def _sbox_np(x: np.ndarray) -> np.ndarray:
    x2 = H.fmul(x, x)
    x4 = H.fmul(x2, x2)
    return H.fmul(H.fmul(x4, x2), x)


def permute_np(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation, host ground truth. state: (24, ...) standard form."""
    c = constants()
    rc_ext, rc_int, diag = c["rc_ext"], c["rc_int"], c["diag"]
    x = np.asarray(state, dtype=np.uint64) % H.PU
    x = _external_np(x)
    half = ROUNDS_FULL // 2
    for r in range(half):
        x = (x + rc_ext[r].reshape((CELLS,) + (1,) * (x.ndim - 1))) % H.PU
        x = _external_np(_sbox_np(x))
    for r in range(ROUNDS_PARTIAL):
        x[0] = (x[0] + rc_int[r]) % H.PU
        x[0] = _sbox_np(x[0])
        s = x.sum(axis=0) % H.PU  # 24 * (p-1) < 2^36 fits uint64
        x = (s[None] + H.fmul(x, (diag - 1).reshape((CELLS,) + (1,) * (x.ndim - 1)) % H.PU)) % H.PU
    for r in range(half, ROUNDS_FULL):
        x = (x + rc_ext[r].reshape((CELLS,) + (1,) * (x.ndim - 1))) % H.PU
        x = _external_np(_sbox_np(x))
    return x


def hash_rows_np(rows: np.ndarray) -> np.ndarray:
    """Sponge-hash rows of field elements. rows: (n, k) -> digests (n, 8)."""
    rows = np.asarray(rows, dtype=np.uint64) % H.PU
    n, k = rows.shape
    state = np.zeros((CELLS, n), dtype=np.uint64)
    for off in range(0, max(k, 1), RATE):
        chunk = rows[:, off:off + RATE].T
        state[:chunk.shape[0]] = (state[:chunk.shape[0]] + chunk) % H.PU
        state = permute_np(state)
    return state[:DIGEST_LEN].T.copy()


# Domain-separation tag for 2-to-1 (inner node) compression, in capacity
# cell 16: an inner-node digest never collides with a leaf hash.
PAIR_TAG = 1


def hash_pairs_np(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Combine digest pairs: (n, 8) x (n, 8) -> (n, 8) in one permutation."""
    n = left.shape[0]
    state = np.zeros((CELLS, n), dtype=np.uint64)
    state[:DIGEST_LEN] = np.asarray(left, dtype=np.uint64).T % H.PU
    state[DIGEST_LEN:2 * DIGEST_LEN] = np.asarray(right, dtype=np.uint64).T % H.PU
    state[2 * DIGEST_LEN] = PAIR_TAG
    return permute_np(state)[:DIGEST_LEN].T.copy()


# ---------------------------------------------------------------------------
# Device functions (torch; Montgomery int32 in and out)
# ---------------------------------------------------------------------------

_STD_TABLES: dict = {}


def _std_tables(device):
    """Standard-form int64 round constants on `device`, shaped to broadcast
    over a (24, batch) state."""
    key = str(device)
    t = _STD_TABLES.get(key)
    if t is None:
        c = constants()
        t = (torch.tensor(c["rc_ext"].astype(np.int64), device=device)
             .reshape(ROUNDS_FULL, CELLS, 1),
             [int(v) for v in c["rc_int"]],
             torch.tensor(((c["diag"] - 1) % P).astype(np.int64),
                          device=device).reshape(CELLS, 1))
        _STD_TABLES[key] = t
    return t


def _external_std(x):
    """M_E on a (24, B) int64 standard-form state (one reduction)."""
    b = x.reshape(CELLS // 4, 4, -1)
    x0, x1, x2, x3 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    z = torch.stack([5 * x0 + 7 * x1 + x2 + 3 * x3,
                     4 * x0 + 6 * x1 + x2 + x3,
                     x0 + 3 * x1 + 5 * x2 + 7 * x3,
                     x0 + x1 + 4 * x2 + 6 * x3], dim=1)   # < 16p each
    z += z.sum(dim=0, keepdim=True)                         # < 112p
    return z.fmod_(P).reshape(x.shape)


def _sbox_std(x):
    x2 = (x * x).fmod_(P)
    x4 = (x2 * x2).fmod_(P)
    return ((x4 * x2).fmod_(P) * x).fmod_(P)


def permute_std(x):
    """Poseidon2 permutation of a (24, B) int64 standard-form state.

    Every value stays non-negative, so ``fmod`` is the reduction (it is
    many times faster than ``%`` on the CPU)."""
    rc_ext, rc_int, dm1 = _std_tables(x.device)
    half = ROUNDS_FULL // 2
    x = _external_std(x)
    for r in range(half):
        x = _external_std(_sbox_std((x + rc_ext[r]).fmod_(P)))
    for r in range(ROUNDS_PARTIAL):
        x = x.clone()
        x[0] = _sbox_std((x[0] + rc_int[r]).fmod_(P))
        s = x.sum(dim=0)                                    # < 24p
        x = (x * dm1).add_(s).fmod_(P)                      # < 2^62 + 2^36
    for r in range(half, ROUNDS_FULL):
        x = _external_std(_sbox_std((x + rc_ext[r]).fmod_(P)))
    return x


def _to_std(a):
    return (a.to(torch.int64) * RINV).fmod_(P)


def _to_monty32(x):
    return (x * R).fmod_(P).to(torch.int32)


def hash_rows(rows):
    """Plain sponge hash of rows. rows: (n, k) int32 Montgomery -> (n, 8).

    Rate 16, add-into-rate absorb, ragged last chunk zero-padded (the
    host's partial absorb), digest = first 8 cells. This is the plain
    version of both CUDA kernels; ``leaf_hash`` and ``sponge_hash`` pick
    between it and theirs.
    """
    n, k = rows.shape
    state = torch.zeros((CELLS, n), dtype=torch.int64, device=rows.device)
    for off in range(0, max(k, 1), RATE):
        w = min(RATE, k - off)
        if w > 0:
            chunk = _to_std(rows[:, off:off + w].T)
            state[:w] = (state[:w] + chunk).fmod_(P)
        state = permute_std(state)
    return _to_monty32(state[:DIGEST_LEN].T).contiguous()


def hash_pairs(left, right):
    """Combine digest pairs: (n, 8) x (n, 8) int32 Montgomery -> (n, 8)."""
    n = left.shape[0]
    state = torch.zeros((CELLS, n), dtype=torch.int64, device=left.device)
    state[:DIGEST_LEN] = _to_std(left.T)
    state[DIGEST_LEN:2 * DIGEST_LEN] = _to_std(right.T)
    state[2 * DIGEST_LEN] = PAIR_TAG
    return _to_monty32(permute_std(state)[:DIGEST_LEN].T).contiguous()
