"""Batched SHA-256 compression on torch tensors + host helpers.

Counterpart of ``zeth_tpu.hash.sha256``: the constants and the host
helpers are a jax-free copy; ``compress``, ``hash_blocks`` and
``hash_pairs`` are the batched device functions on torch tensors. Words
are uint32 values held as int32 (the port's convention for 32-bit data)
and widened to int64 inside, so that every shift is a logical one.

Layout: batch leading; per-message state is 8 words, a message block 16
big-endian words.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# FIPS 180-4 constants (public).
_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2], dtype=np.uint32)

IV = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19], dtype=np.uint32)

_M32 = 0xFFFFFFFF


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _to_i32(x):
    """int64 tensor of uint32 values -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def compress(state, block):
    """One SHA-256 compression. state: (b, 8), block: (b, 16) int32
    words -> (b, 8) int32 words."""
    s = state.to(torch.int64) & _M32
    w = [c for c in (block.to(torch.int64) & _M32).T]
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
        s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = s.T
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((~e) & g)
        t1 = (h + s1 + ch + int(_K[t]) + w[t]) & _M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                  (t1 + s0 + maj) & _M32)
    out = torch.stack([a, b, c, d, e, f, g, h], dim=1)
    return _to_i32((s + out) & _M32)


def _iv(b: int, device):
    return torch.as_tensor(IV.view(np.int32), device=device).expand(b, 8)


def hash_blocks(blocks):
    """Chain-compress multi-block messages. blocks: (b, nblk, 16) -> (b, 8)."""
    state = _iv(blocks.shape[0], blocks.device)
    for i in range(blocks.shape[1]):
        state = compress(state, blocks[:, i])
    return state


def hash_pairs(left, right):
    """Merkle combine: two 8-word digests -> one compression, no padding."""
    block = torch.cat([left, right], dim=-1)
    return compress(_iv(block.shape[0], block.device), block)


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------


def sha256_bytes(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def words_be(data: bytes) -> np.ndarray:
    assert len(data) % 4 == 0
    return np.frombuffer(data, dtype=">u4").astype(np.uint32)


def digest_to_bytes(words: np.ndarray) -> bytes:
    return np.asarray(words, dtype=">u4").tobytes()


def pad_message(data: bytes) -> np.ndarray:
    """FIPS 180-4 padding -> (nblk, 16) big-endian words."""
    bitlen = len(data) * 8
    data = data + b"\x80"
    while len(data) % 64 != 56:
        data += b"\x00"
    data += bitlen.to_bytes(8, "big")
    return words_be(data).reshape(-1, 16)
