"""Minimal RLP encode/decode (Ethereum's serialization).

Needed by the sparse MPT (zeth_tpu_torch.app.trie) — the reference gets this
from alloy-rlp (SURVEY.md §2.1, crates/core deps). Items are bytes or
(recursively) lists of items.
"""

from __future__ import annotations


def encode(item) -> bytes:
    if isinstance(item, int):
        if item == 0:
            item = b""
        else:
            item = item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def decode(data: bytes):
    """Decode one item; returns (item, remaining). Lists decode to lists."""
    item, rest = _decode_one(memoryview(data))
    return item, bytes(rest)


def decode_full(data: bytes):
    item, rest = decode(data)
    if rest:
        raise ValueError("trailing RLP bytes")
    return item


def _decode_one(mv):
    if not len(mv):
        raise ValueError("empty RLP")
    b0 = mv[0]
    if b0 < 0x80:
        return bytes(mv[0:1]), mv[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        return bytes(mv[1:1 + n]), mv[1 + n:]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(bytes(mv[1:1 + ln]), "big")
        return bytes(mv[1 + ln:1 + ln + n]), mv[1 + ln + n:]
    if b0 < 0xF8:
        n = b0 - 0xC0
        payload = mv[1:1 + n]
        rest = mv[1 + n:]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(bytes(mv[1:1 + ln]), "big")
        payload = mv[1 + ln:1 + ln + n]
        rest = mv[1 + ln + n:]
    items = []
    while len(payload):
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
