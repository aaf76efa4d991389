"""Transaction envelopes: decode RPC JSON, re-encode RLP, recover senders.

The reference gets typed-transaction handling from alloy/reth (SURVEY.md
§2.2 reth-stateless stack); this module implements the envelope types the
post-merge chain actually carries: legacy (+EIP-155), EIP-2930, EIP-1559
and EIP-4844. Canonical encodings feed the transactions-root check and
the signing hashes feed sender recovery (native secp256k1, app.evm).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..hash.keccak import keccak256
from . import rlp

GAS_PER_BLOB = 131072
TARGET_BLOB_GAS = 393216           # 3 blobs (Cancun)
MAX_BLOB_GAS = 786432
BLOB_BASE_FEE_UPDATE_FRACTION = 3338477
MIN_BLOB_BASE_FEE = 1


def _to_bytes(v) -> bytes:
    if v in (None, "0x", ""):
        return b""
    if isinstance(v, str):
        h = v[2:] if v.startswith("0x") else v
        if len(h) % 2:
            h = "0" + h
        return bytes.fromhex(h)
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    raise TypeError(type(v))


def _to_int(v) -> int:
    if v is None:
        return 0
    if isinstance(v, str):
        return int(v, 16) if v.startswith("0x") else int(v)
    return int(v)


def _get(d: dict, *names, default=None):
    for n in names:
        if n in d and d[n] is not None:
            return d[n]
    return default


@dataclass
class Authorization:
    """EIP-7702 authorization tuple (type-4 transactions, Prague)."""
    chain_id: int
    address: bytes
    nonce: int
    y_parity: int
    r: int
    s: int

    @classmethod
    def from_json(cls, d: dict) -> "Authorization":
        return cls(
            chain_id=_to_int(_get(d, "chainId", "chain_id", default=0)),
            address=_to_bytes(_get(d, "address", default="0x" + "00" * 20)),
            nonce=_to_int(_get(d, "nonce", default=0)),
            y_parity=_to_int(_get(d, "yParity", "y_parity", "v", default=0)),
            r=_to_int(_get(d, "r", default=0)),
            s=_to_int(_get(d, "s", default=0)),
        )

    def rlp_items(self) -> list:
        return [self.chain_id, self.address, self.nonce,
                self.y_parity, self.r, self.s]

    def signing_hash(self) -> bytes:
        from . import rlp as _rlp
        return keccak256(
            b"\x05" + _rlp.encode([self.chain_id, self.address, self.nonce]))

    def authority(self) -> bytes | None:
        """Recover the authorizing account (None if the sig is invalid)."""
        from .evm import ecrecover
        if self.y_parity not in (0, 1):
            return None
        return ecrecover(self.signing_hash(), self.r, self.s, self.y_parity)

    def pack(self) -> bytes:
        """125-byte wire entry for the native engine (evm.cpp auth_list)."""
        return (self.chain_id.to_bytes(32, "big") + self.address
                + self.nonce.to_bytes(8, "little")
                + bytes([self.y_parity])
                + self.r.to_bytes(32, "big") + self.s.to_bytes(32, "big"))


@dataclass
class Tx:
    type: int
    nonce: int
    gas_limit: int
    to: bytes | None            # None = create
    value: int
    data: bytes
    v: int
    r: int
    s: int
    chain_id: int | None = None
    gas_price: int | None = None            # legacy / 2930
    max_fee: int | None = None              # 1559 / 4844
    max_priority_fee: int | None = None
    access_list: list = field(default_factory=list)   # [(addr, [slots])]
    max_fee_per_blob_gas: int | None = None
    blob_hashes: list = field(default_factory=list)
    authorization_list: list = field(default_factory=list)  # EIP-7702
    from_field: bytes | None = None         # RPC-provided sender

    @classmethod
    def from_json(cls, d: dict) -> "Tx":
        typ = _to_int(_get(d, "type", default=0))
        to = _get(d, "to")
        acl = []
        for e in _get(d, "accessList", "access_list", default=[]) or []:
            addr = _to_bytes(_get(e, "address"))
            keys = [_to_bytes(k) for k in _get(e, "storageKeys",
                                               "storage_keys", default=[])]
            acl.append((addr, keys))
        return cls(
            type=typ,
            nonce=_to_int(_get(d, "nonce", default=0)),
            gas_limit=_to_int(_get(d, "gas", "gasLimit", "gas_limit",
                                   default=0)),
            to=_to_bytes(to) if to else None,
            value=_to_int(_get(d, "value", default=0)),
            data=_to_bytes(_get(d, "input", "data", default="0x")),
            v=_to_int(_get(d, "v", "yParity", "y_parity", default=0)),
            r=_to_int(_get(d, "r", default=0)),
            s=_to_int(_get(d, "s", default=0)),
            chain_id=(_to_int(_get(d, "chainId", "chain_id"))
                      if _get(d, "chainId", "chain_id") is not None else None),
            gas_price=(_to_int(_get(d, "gasPrice", "gas_price"))
                       if _get(d, "gasPrice", "gas_price") is not None
                       else None),
            max_fee=(_to_int(_get(d, "maxFeePerGas", "max_fee_per_gas"))
                     if _get(d, "maxFeePerGas", "max_fee_per_gas") is not None
                     else None),
            max_priority_fee=(
                _to_int(_get(d, "maxPriorityFeePerGas",
                             "max_priority_fee_per_gas"))
                if _get(d, "maxPriorityFeePerGas",
                        "max_priority_fee_per_gas") is not None else None),
            access_list=acl,
            max_fee_per_blob_gas=(
                _to_int(_get(d, "maxFeePerBlobGas", "max_fee_per_blob_gas"))
                if _get(d, "maxFeePerBlobGas",
                        "max_fee_per_blob_gas") is not None else None),
            blob_hashes=[_to_bytes(h) for h in
                         _get(d, "blobVersionedHashes",
                              "blob_versioned_hashes", default=[]) or []],
            authorization_list=[
                Authorization.from_json(a) for a in
                _get(d, "authorizationList", "authorization_list",
                     default=[]) or []],
            from_field=_to_bytes(_get(d, "from")) if _get(d, "from") else None,
        )

    # -- canonical encoding (transactions root) ---------------------------

    def _acl_rlp(self):
        return [[a, list(ks)] for a, ks in self.access_list]

    def encode(self) -> bytes:
        to = self.to if self.to is not None else b""
        if self.type == 0:
            return rlp.encode([self.nonce, self.gas_price, self.gas_limit,
                               to, self.value, self.data,
                               self.v, self.r, self.s])
        if self.type == 1:
            body = rlp.encode([self.chain_id, self.nonce, self.gas_price,
                               self.gas_limit, to, self.value, self.data,
                               self._acl_rlp(), self.v, self.r, self.s])
            return b"\x01" + body
        if self.type == 2:
            body = rlp.encode([self.chain_id, self.nonce,
                               self.max_priority_fee, self.max_fee,
                               self.gas_limit, to, self.value, self.data,
                               self._acl_rlp(), self.v, self.r, self.s])
            return b"\x02" + body
        if self.type == 3:
            body = rlp.encode([self.chain_id, self.nonce,
                               self.max_priority_fee, self.max_fee,
                               self.gas_limit, to, self.value, self.data,
                               self._acl_rlp(), self.max_fee_per_blob_gas,
                               list(self.blob_hashes),
                               self.v, self.r, self.s])
            return b"\x03" + body
        if self.type == 4:                  # EIP-7702 SetCode (Prague)
            body = rlp.encode([self.chain_id, self.nonce,
                               self.max_priority_fee, self.max_fee,
                               self.gas_limit, to, self.value, self.data,
                               self._acl_rlp(),
                               [a.rlp_items()
                                for a in self.authorization_list],
                               self.v, self.r, self.s])
            return b"\x04" + body
        raise ValueError(f"unsupported tx type {self.type}")

    # -- signing hash + sender recovery -----------------------------------

    def signing_hash(self) -> tuple[bytes, int]:
        """Returns (hash, recovery_id)."""
        to = self.to if self.to is not None else b""
        if self.type == 0:
            if self.v >= 35:                      # EIP-155
                chain_id = (self.v - 35) // 2
                rec = (self.v - 35) % 2
                pre = rlp.encode([self.nonce, self.gas_price, self.gas_limit,
                                  to, self.value, self.data,
                                  chain_id, b"", b""])
            else:
                rec = self.v - 27
                pre = rlp.encode([self.nonce, self.gas_price, self.gas_limit,
                                  to, self.value, self.data])
            return keccak256(pre), rec
        if self.type == 1:
            pre = b"\x01" + rlp.encode(
                [self.chain_id, self.nonce, self.gas_price, self.gas_limit,
                 to, self.value, self.data, self._acl_rlp()])
        elif self.type == 2:
            pre = b"\x02" + rlp.encode(
                [self.chain_id, self.nonce, self.max_priority_fee,
                 self.max_fee, self.gas_limit, to, self.value, self.data,
                 self._acl_rlp()])
        elif self.type == 3:
            pre = b"\x03" + rlp.encode(
                [self.chain_id, self.nonce, self.max_priority_fee,
                 self.max_fee, self.gas_limit, to, self.value, self.data,
                 self._acl_rlp(), self.max_fee_per_blob_gas,
                 list(self.blob_hashes)])
        elif self.type == 4:
            pre = b"\x04" + rlp.encode(
                [self.chain_id, self.nonce, self.max_priority_fee,
                 self.max_fee, self.gas_limit, to, self.value, self.data,
                 self._acl_rlp(),
                 [a.rlp_items() for a in self.authorization_list]])
        else:
            raise ValueError(f"unsupported tx type {self.type}")
        return keccak256(pre), self.v

    def recover_sender(self) -> bytes | None:
        from .evm import ecrecover
        h, rec = self.signing_hash()
        if rec >= 27:
            rec -= 27
        if rec not in (0, 1):
            return None
        return ecrecover(h, self.r, self.s, rec)

    def sender(self) -> bytes:
        """RPC-provided sender cross-checked against signature recovery
        when a signature is present; recovery alone otherwise."""
        if self.r or self.s:
            rec = self.recover_sender()
            if rec is not None:
                if self.from_field is not None and rec != self.from_field:
                    raise ValueError("tx sender does not match signature")
                return rec
        if self.from_field is not None:
            return self.from_field
        raise ValueError("cannot determine tx sender")

    # -- fees ---------------------------------------------------------------

    def effective_gas_price(self, basefee: int) -> tuple[int, int]:
        """(effective price, miner tip per gas)."""
        if self.type in (0, 1):
            price = self.gas_price or 0
            return price, max(price - basefee, 0)
        price = min(self.max_fee or 0,
                    basefee + (self.max_priority_fee or 0))
        return price, max(price - basefee, 0)


def fake_exponential(factor: int, numerator: int, denominator: int) -> int:
    """EIP-4844 blob base fee curve."""
    i = 1
    output = 0
    acc = factor * denominator
    while acc > 0:
        output += acc
        acc = acc * numerator // (denominator * i)
        i += 1
    return output // denominator


def blob_base_fee(excess_blob_gas: int,
                  update_fraction: int = BLOB_BASE_FEE_UPDATE_FRACTION) -> int:
    """Blob base fee; the update fraction is fork-dependent from Prague
    (chainspec.blob_params_at — EIP-7691 raised it with the blob count,
    mirrored from crates/chainspec/src/lib.rs:141-153)."""
    return fake_exponential(MIN_BLOB_BASE_FEE, excess_blob_gas,
                            update_fraction)
