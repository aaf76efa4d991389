"""The stateless-client input model: ``StatelessInput`` and its JSON reader.

Copy of the input half of ``zeth_tpu.app.host``. Input format: the
reference's cached `StatelessInput` JSON — {"block": {..header fields..,
"transactions": [...]}, "witness": {"state": [hex], "codes": [hex],
"headers": [hex], "keys": ignored}}. Field names accept both camelCase
and snake_case.

Block validation, the block processor, RPC fetch and proving dispatch of
the JAX package's module are not carried yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash.keccak import keccak256
from . import rlp

# header fields in RLP order: (name, kind, optional_since_fork)
# kind: h=hash/bytes32, a=address, b=raw bytes, i=int
_HEADER_FIELDS = [
    ("parent_hash", "h", None),
    ("ommers_hash", "h", None),
    ("beneficiary", "a", None),
    ("state_root", "h", None),
    ("transactions_root", "h", None),
    ("receipts_root", "h", None),
    ("logs_bloom", "b", None),
    ("difficulty", "i", None),
    ("number", "i", None),
    ("gas_limit", "i", None),
    ("gas_used", "i", None),
    ("timestamp", "i", None),
    ("extra_data", "b", None),
    ("mix_hash", "h", None),
    ("nonce", "b", None),
    ("base_fee_per_gas", "i", "london"),
    ("withdrawals_root", "h", "shanghai"),
    ("blob_gas_used", "i", "cancun"),
    ("excess_blob_gas", "i", "cancun"),
    ("parent_beacon_block_root", "h", "cancun"),
    ("requests_hash", "h", "prague"),
]

_ALIASES = {
    "ommers_hash": ["sha3Uncles", "unclesHash"],
    "beneficiary": ["miner", "coinbase"],
    "mix_hash": ["prevRandao"],
}


def _camel(s: str) -> str:
    parts = s.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def _get_field(d: dict, name: str):
    for k in [name, _camel(name)] + _ALIASES.get(name, []):
        if k in d and d[k] is not None:
            return d[k]
    return None


def _to_bytes(v) -> bytes:
    if isinstance(v, str):
        return bytes.fromhex(v[2:] if v.startswith("0x") else v)
    if isinstance(v, list):
        return bytes(v)
    raise TypeError(type(v))


def _to_int(v) -> int:
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


@dataclass
class Header:
    fields: dict                # name -> decoded value (bytes or int)

    @classmethod
    def from_json(cls, d: dict) -> "Header":
        out = {}
        for name, kind, _ in _HEADER_FIELDS:
            v = _get_field(d, name)
            if v is None:
                continue
            out[name] = _to_int(v) if kind == "i" else _to_bytes(v)
        return cls(out)

    @classmethod
    def from_rlp(cls, raw: bytes) -> "Header":
        items = rlp.decode_full(raw)
        out = {}
        for (name, kind, _), item in zip(_HEADER_FIELDS, items):
            out[name] = int.from_bytes(item, "big") if kind == "i" else bytes(item)
        return cls(out)

    def encode(self) -> bytes:
        items = []
        for name, kind, _ in _HEADER_FIELDS:
            if name not in self.fields:
                continue
            items.append(self.fields[name])
        return rlp.encode(items)

    def hash(self) -> bytes:
        return keccak256(self.encode())

    @property
    def number(self) -> int:
        return self.fields["number"]

    @property
    def state_root(self) -> bytes:
        return self.fields["state_root"]

    @property
    def parent_hash(self) -> bytes:
        return self.fields["parent_hash"]


@dataclass
class ExecutionWitness:
    state: list                 # RLP trie nodes (bytes)
    codes: list                 # contract bytecodes
    headers: list               # RLP-encoded ancestor headers, parent first

    @classmethod
    def from_json(cls, d: dict) -> "ExecutionWitness":
        return cls(
            state=[_to_bytes(x) for x in d.get("state", [])],
            codes=[_to_bytes(x) for x in d.get("codes", [])],
            headers=[_to_bytes(x) for x in d.get("headers", [])],
        )


@dataclass
class StatelessInput:
    block: Header
    transactions: list
    witness: ExecutionWitness
    withdrawals: list = field(default_factory=list)
    raw: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_json(cls, d: dict) -> "StatelessInput":
        block = d["block"]
        header_src = block.get("header", block)
        body = block.get("body", {})
        return cls(
            block=Header.from_json(header_src),
            transactions=body.get("transactions",
                                  block.get("transactions", [])),
            witness=ExecutionWitness.from_json(d["witness"]),
            withdrawals=body.get("withdrawals",
                                 block.get("withdrawals", [])) or [],
            raw=d,
        )
