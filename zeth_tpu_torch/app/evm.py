"""EVM block execution: ctypes driver for the native engine (csrc/evm.cpp).

Completes zeth-core's validate_block (reference crates/core/src/lib.rs:34-53,
which delegates to reth's stateless_validation_with_trie): execute every
transaction of a block against the witness-backed SparseState, credit
withdrawals and fees, and produce the post-state update set + receipts.

The C++ engine owns the interpreter/gas/precompiles and a journaled
write-back cache; this module supplies state callbacks (account/storage/
code/blockhash reads from the witness) and block/tx-level protocol logic
(EIP-1559 fees, blob fees, receipts, bloom, withdrawals, system calls).

Counterpart of ``zeth_tpu.app.evm``, a jax-free copy over the port's own
engine source (``zeth_tpu_torch/app/csrc/evm.cpp``). ``libevm.so`` is
built with ``make`` at first use in a process (make rebuilds it when
``evm.cpp`` is newer); a failed build raises with make's output, and
nothing stands in for the engine.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from dataclasses import dataclass, field

from ..hash.keccak import keccak256
from . import rlp
from .state import EMPTY_CODE_HASH, SparseState

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "csrc", "libevm.so")

_GET_ACCOUNT = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_uint64),
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_uint8))
_GET_CODE = ctypes.CFUNCTYPE(ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint8),
                             ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64)
_GET_STORAGE = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_uint8),
                                ctypes.POINTER(ctypes.c_uint8))
_BLOCK_HASH = ctypes.CFUNCTYPE(None, ctypes.c_uint64,
                               ctypes.POINTER(ctypes.c_uint8))
_KZG = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_uint8))
_PAIRING = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
                            ctypes.c_uint64)
_BLS = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64,
                        ctypes.POINTER(ctypes.c_uint8),
                        ctypes.POINTER(ctypes.c_uint64))


def _build() -> None:
    """Build libevm.so with make (which does nothing while it is newer
    than evm.cpp). A lock file serialises processes that build at once
    (test workers), so none loads a half-written library."""
    with open(os.path.join(_DIR, "csrc", ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.run(["make", "-s", "-C", os.path.join(_DIR, "csrc")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {_SO} failed (make exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")


def _lib():
    _build()
    lib = ctypes.CDLL(_SO)
    lib.evm_create.restype = ctypes.c_void_p
    lib.evm_create.argtypes = [_GET_ACCOUNT, _GET_CODE, _GET_STORAGE,
                               _BLOCK_HASH]
    lib.evm_destroy.argtypes = [ctypes.c_void_p]
    lib.evm_set_block.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64,
                                  ctypes.c_uint64, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_uint64]
    lib.evm_add_balance.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p]
    lib.evm_exec_tx.restype = ctypes.c_int
    lib.evm_exec_tx.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p]
    lib.evm_set_fork.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.evm_set_bls_cb.argtypes = [ctypes.c_void_p, _BLS]
    lib.evm_system_call_out.restype = ctypes.c_int64
    lib.evm_system_call_out.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_char_p, ctypes.c_uint64]
    lib.evm_last_error.restype = ctypes.c_char_p
    lib.evm_last_error.argtypes = [ctypes.c_void_p]
    lib.evm_system_call.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_uint64]
    lib.evm_set_pairing_cb.argtypes = [ctypes.c_void_p, _PAIRING]
    lib.evm_set_kzg_cb.argtypes = [ctypes.c_void_p, _KZG]
    lib.evm_log_count.restype = ctypes.c_uint64
    lib.evm_log_count.argtypes = [ctypes.c_void_p]
    lib.evm_get_log.restype = ctypes.c_uint64
    lib.evm_get_log.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.c_char_p, ctypes.c_uint64]
    lib.evm_clear_logs.argtypes = [ctypes.c_void_p]
    lib.evm_touched_accounts.restype = ctypes.c_uint64
    lib.evm_touched_accounts.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_uint64]
    lib.evm_account_state.restype = ctypes.c_int
    lib.evm_account_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_uint64)]
    lib.evm_account_code.restype = ctypes.c_uint64
    lib.evm_account_code.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_uint64]
    lib.evm_touched_storage.restype = ctypes.c_uint64
    lib.evm_touched_storage.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64]
    lib.evm_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p]
    lib.evm_ecrecover.restype = ctypes.c_int
    lib.evm_ecrecover.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_char_p]
    return lib


_LIB = None


def get_lib():
    global _LIB
    if _LIB is None:
        _LIB = _lib()
    return _LIB


def _b32(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


@dataclass
class Log:
    address: bytes
    topics: list
    data: bytes


@dataclass
class TxResult:
    status: int            # 1 success, 0 reverted
    gas_used: int
    logs: list = field(default_factory=list)
    created: bytes | None = None


class ExecutionError(Exception):
    pass


class BlockEvm:
    """One block execution over a SparseState-backed host interface."""

    def __init__(self, state: SparseState, ancestors: dict[int, bytes]):
        """ancestors: block number -> hash (for BLOCKHASH)."""
        self.lib = get_lib()
        self.state = state
        self.ancestors = ancestors

        def get_account(addr_p, nonce_p, bal_p, ch_p):
            addr = bytes(addr_p[:20])
            acct = state.account(addr)
            if acct is None:
                return 0
            nonce_p[0] = acct.nonce
            bal = acct.balance.to_bytes(32, "big")
            for i in range(32):
                bal_p[i] = bal[i]
            for i in range(32):
                ch_p[i] = acct.code_hash[i]
            return 1

        def get_code(ch_p, buf_p, cap):
            code = state.code(bytes(ch_p[:32]))
            if code is None:
                # witness is incomplete: surface loudly via empty code +
                # recorded miss (validation will fail on the state root)
                self.missing_codes.add(bytes(ch_p[:32]))
                return 0
            n = len(code)
            if buf_p and n <= cap:
                ctypes.memmove(buf_p, code, n)
            return n

        def get_storage(addr_p, key_p, val_p):
            v = state.storage(bytes(addr_p[:20]), bytes(key_p[:32]))
            enc = int(v).to_bytes(32, "big")
            for i in range(32):
                val_p[i] = enc[i]

        def block_hash(number, out_p):
            h = self.ancestors.get(int(number), b"\x00" * 32)
            for i in range(32):
                out_p[i] = h[i]

        def pairing_cb(inp_p, length):
            from . import bn254
            try:
                data = bytes(inp_p[:length]) if length else b""
                pairs = []
                for off in range(0, len(data), 192):
                    chunk = data[off:off + 192]
                    ax = int.from_bytes(chunk[0:32], "big")
                    ay = int.from_bytes(chunk[32:64], "big")
                    # EVM G2 encoding: imaginary limb first
                    bxi = int.from_bytes(chunk[64:96], "big")
                    bxr = int.from_bytes(chunk[96:128], "big")
                    byi = int.from_bytes(chunk[128:160], "big")
                    byr = int.from_bytes(chunk[160:192], "big")
                    if max(ax, ay, bxi, bxr, byi, byr) >= bn254.P:
                        return -1
                    g1 = None if (ax == 0 and ay == 0) else (ax, ay)
                    g2 = None if (bxr | bxi | byr | byi) == 0 \
                        else ((bxr, bxi), (byr, byi))
                    pairs.append((g1, g2))
                return 1 if bn254.pairing_check(pairs) else 0
            except (ValueError, OverflowError):
                return -1

        def kzg_cb(inp_p):
            from . import kzg
            try:
                kzg.point_evaluation(bytes(inp_p[:192]))
                return 1
            except kzg.KzgError as e:
                if "not provisioned" in str(e):
                    return -1
                return 0

        def bls_cb(op, inp_p, length, out_p, outlen_p):
            from . import bls12381
            try:
                data = bytes(inp_p[:length]) if length else b""
                res = bls12381.eip2537_dispatch(op, data)
            except ValueError:
                return 0
            except NotImplementedError:
                return -1
            ctypes.memmove(out_p, res, len(res))
            outlen_p[0] = len(res)
            return 1

        # keep callback objects alive for the handle's lifetime
        self._cbs = (_GET_ACCOUNT(get_account), _GET_CODE(get_code),
                     _GET_STORAGE(get_storage), _BLOCK_HASH(block_hash))
        self._pairing_cb = _PAIRING(pairing_cb)
        self._kzg_cb = _KZG(kzg_cb)
        self._bls_cb = _BLS(bls_cb)
        self.h = self.lib.evm_create(*self._cbs)
        self.lib.evm_set_pairing_cb(self.h, self._pairing_cb)
        self.lib.evm_set_kzg_cb(self.h, self._kzg_cb)
        self.lib.evm_set_bls_cb(self.h, self._bls_cb)
        self.missing_codes: set[bytes] = set()
        self._log_cursor = 0

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.evm_destroy(self.h)
            self.h = None

    def set_block(self, *, coinbase: bytes, number: int, timestamp: int,
                  gas_limit: int, basefee: int, prevrandao: bytes,
                  blob_basefee: int, chain_id: int):
        self.lib.evm_set_block(self.h, coinbase, number, timestamp,
                               gas_limit, _b32(basefee), prevrandao,
                               _b32(blob_basefee), chain_id)

    def add_balance(self, addr: bytes, amount: int):
        self.lib.evm_add_balance(self.h, addr, _b32(amount))

    def set_fork(self, *, is_prague: bool):
        self.lib.evm_set_fork(self.h, 1 if is_prague else 0)

    def system_call(self, to: bytes, data: bytes):
        """EIP-4788-style protocol call (no fees/nonce/receipt)."""
        self.lib.evm_system_call(self.h, to, data, len(data))
        self._log_cursor = self.lib.evm_log_count(self.h)

    def system_call_out(self, to: bytes, data: bytes = b"") -> bytes | None:
        """System call capturing return data (EIP-7002/7251 request
        contracts). None if the target has no code; raises on failure."""
        cap = 1 << 16
        out = ctypes.create_string_buffer(cap)
        n = self.lib.evm_system_call_out(self.h, to, data, len(data),
                                         out, cap)
        self._log_cursor = self.lib.evm_log_count(self.h)
        if n == -1:
            return None
        if n < 0:
            raise ExecutionError("system call failed")
        if n > cap:
            raise ExecutionError("system call output too large")
        return out.raw[:n]

    def exec_tx(self, *, sender: bytes, to: bytes | None, value: int,
                gas_limit: int, eff_gas_price: int, tip_per_gas: int,
                data: bytes, access_list=None, blob_hashes=None,
                blob_fee: int = 0, nonce: int = 0,
                authorization_list=None) -> TxResult:
        acl = b""
        for addr, slots in (access_list or []):
            acl += addr + len(slots).to_bytes(4, "little")
            for s in slots:
                acl += s
        bh = b"".join(blob_hashes or [])
        auth = b"".join(a.pack() for a in (authorization_list or []))
        gas_used = ctypes.c_uint64(0)
        created = ctypes.create_string_buffer(20)
        rc = self.lib.evm_exec_tx(
            self.h, sender, to, _b32(value), gas_limit, _b32(eff_gas_price),
            _b32(tip_per_gas), data, len(data), acl, len(acl), bh,
            len(blob_hashes or []), _b32(blob_fee), nonce,
            auth, len(authorization_list or []),
            ctypes.byref(gas_used), created)
        if rc == -2:
            raise ExecutionError(
                self.lib.evm_last_error(self.h).decode() or "engine error")
        if rc < 0:
            raise ExecutionError(f"invalid transaction (rc={rc})")
        logs = self._drain_logs()
        return TxResult(status=rc, gas_used=int(gas_used.value), logs=logs,
                        created=bytes(created.raw) if to is None else None)

    def _drain_logs(self) -> list:
        out = []
        n = self.lib.evm_log_count(self.h)
        for i in range(self._log_cursor, n):
            need = self.lib.evm_get_log(self.h, i, None, 0)
            buf = ctypes.create_string_buffer(need)
            self.lib.evm_get_log(self.h, i, buf, need)
            raw = buf.raw
            addr = raw[:20]
            nt = int.from_bytes(raw[20:24], "little")
            topics = [raw[24 + 32 * j:24 + 32 * (j + 1)] for j in range(nt)]
            off = 24 + 32 * nt
            nd = int.from_bytes(raw[off:off + 4], "little")
            data = raw[off + 4:off + 4 + nd]
            out.append(Log(addr, topics, data))
        self._log_cursor = n
        return out

    def state_diff(self) -> dict:
        """Post-state update set for SparseState.calculate_state_root."""
        n = self.lib.evm_touched_accounts(self.h, None, 0)
        buf = ctypes.create_string_buffer(20 * n)
        self.lib.evm_touched_accounts(self.h, buf, n)
        addrs = [buf.raw[20 * i:20 * (i + 1)] for i in range(n)]

        ns = self.lib.evm_touched_storage(self.h, None, 0)
        sbuf = ctypes.create_string_buffer(84 * ns)
        self.lib.evm_touched_storage(self.h, sbuf, ns)
        storage: dict[bytes, dict] = {}
        for i in range(ns):
            rec = sbuf.raw[84 * i:84 * (i + 1)]
            a, k, v = rec[:20], rec[20:52], rec[52:84]
            storage.setdefault(a, {})[k] = int.from_bytes(v, "big")

        post = {}
        for a in addrs:
            nonce = ctypes.c_uint64(0)
            bal = ctypes.create_string_buffer(32)
            ch = ctypes.create_string_buffer(32)
            clen = ctypes.c_uint64(0)
            exists = self.lib.evm_account_state(
                self.h, a, ctypes.byref(nonce), bal, ch, ctypes.byref(clen))
            pre = self.state.account(a)
            slots = storage.get(a, {})
            if not exists:
                if pre is not None:
                    post[a] = None
                continue
            fields = {"nonce": int(nonce.value),
                      "balance": int.from_bytes(bal.raw, "big"),
                      "code_hash": bytes(ch.raw)}
            # drop untouched accounts (no change, no storage writes)
            dirty_slots = {}
            for k, v in slots.items():
                if self.state.storage(a, k) != v:
                    dirty_slots[k] = v
            unchanged = (pre is not None and pre.nonce == fields["nonce"]
                         and pre.balance == fields["balance"]
                         and pre.code_hash == fields["code_hash"])
            if unchanged and not dirty_slots:
                continue
            if pre is None and fields["nonce"] == 0 \
                    and fields["balance"] == 0 \
                    and fields["code_hash"] == EMPTY_CODE_HASH \
                    and not dirty_slots:
                continue    # EIP-161: empty accounts are not persisted
            post[a] = (fields, dirty_slots)
        return post

    def new_code(self) -> dict[bytes, bytes]:
        """code_hash -> code for contracts created during the block."""
        out = {}
        n = self.lib.evm_touched_accounts(self.h, None, 0)
        buf = ctypes.create_string_buffer(20 * n)
        self.lib.evm_touched_accounts(self.h, buf, n)
        for i in range(n):
            a = buf.raw[20 * i:20 * (i + 1)]
            nonce = ctypes.c_uint64(0)
            bal = ctypes.create_string_buffer(32)
            ch = ctypes.create_string_buffer(32)
            clen = ctypes.c_uint64(0)
            if not self.lib.evm_account_state(self.h, a, ctypes.byref(nonce),
                                              bal, ch, ctypes.byref(clen)):
                continue
            chb = bytes(ch.raw)
            if chb != EMPTY_CODE_HASH and self.state.code(chb) is None:
                cap = self.lib.evm_account_code(self.h, a, None, 0)
                cbuf = ctypes.create_string_buffer(max(int(cap), 1))
                self.lib.evm_account_code(self.h, a, cbuf, cap)
                out[chb] = cbuf.raw[:cap]
        return out


def ecrecover(msg_hash: bytes, r: int, s: int, rec_id: int) -> bytes | None:
    """Recover the signer address (used for tx sender verification)."""
    out = ctypes.create_string_buffer(20)
    ok = get_lib().evm_ecrecover(msg_hash, _b32(r), _b32(s), rec_id, out)
    return bytes(out.raw) if ok else None


# -- receipts / bloom ---------------------------------------------------------


def logs_bloom(logs: list) -> bytes:
    bloom = bytearray(256)
    for log in logs:
        for item in [log.address] + list(log.topics):
            h = keccak256(item)
            for i in (0, 2, 4):
                bit = ((h[i] << 8) | h[i + 1]) & 0x7FF
                bloom[256 - 1 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


def encode_receipt(tx_type: int, status: int, cumulative_gas: int,
                   logs: list) -> bytes:
    log_items = [[log.address, list(log.topics), log.data] for log in logs]
    payload = rlp.encode([status, cumulative_gas,
                          logs_bloom(logs), log_items])
    if tx_type == 0:
        return payload
    return bytes([tx_type]) + payload


def trie_root(items: list[bytes]) -> bytes:
    """Ordered trie root (transactions/receipts root): key = rlp(index)."""
    from .trie import Trie
    t = Trie()
    for i, item in enumerate(items):
        t.insert(rlp.encode(i), item)
    return t.root_hash()
