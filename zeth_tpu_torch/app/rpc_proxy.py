"""Witness-generation RPC proxy.

Replaces zeth-rpc-proxy (SURVEY.md §2.1, crates/rpc-proxy): a JSON-RPC
HTTP server that answers `debug_executionWitness` locally and forwards
every other method upstream with retry/backoff (RetryBackoffLayer
equivalent, main.rs:207-208). Witnesses come from the full preflight:
EVM re-execution over a recording RPC-backed state + chunked
eth_getProof assembly (zeth_tpu_torch.app.preflight, the reference's
witness.rs pipeline) whenever the upstream lacks the native endpoint.
"""

from __future__ import annotations

import json
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

JSONRPC_INTERNAL = -32603
JSONRPC_INVALID = -32600
JSONRPC_METHOD_NOT_FOUND = -32601


class Upstream:
    """Forwarding client with retry/backoff (10 retries by default)."""

    def __init__(self, url: str, max_retries: int = 10,
                 backoff_ms: int = 200):
        self.url = url
        self.max_retries = max_retries
        self.backoff_ms = backoff_ms

    def call_raw(self, payload: bytes) -> bytes:
        last = None
        for attempt in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(
                    self.url, data=payload,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.read()
            except Exception as e:   # network-level retry
                last = e
                time.sleep(self.backoff_ms / 1000.0 * (attempt + 1))
        raise RuntimeError(f"upstream failed after retries: {last}")

    def call(self, method: str, params: list):
        out = json.loads(self.call_raw(json.dumps(
            {"jsonrpc": "2.0", "id": 1, "method": method,
             "params": params}).encode()))
        if "error" in out:
            raise RuntimeError(f"upstream rpc error: {out['error']}")
        return out["result"]


def execution_witness(upstream: Upstream, block_number: str,
                      chain_id: int | None = None) -> dict:
    """Assemble an ExecutionWitness for a block (witness.rs:33-132).

    Prefers the node's native debug_executionWitness; otherwise runs the
    full preflight: EVM re-execution over a recording RPC-backed state,
    then chunked eth_getProof assembly with post-state hydration
    (zeth_tpu_torch.app.preflight — the reference's witness.rs:75-131 path).
    """
    try:
        return upstream.call("debug_executionWitness", [block_number])
    except RuntimeError:
        pass

    from .chainspec import BY_CHAIN_ID
    from .preflight import execution_witness as preflight_witness
    if chain_id is None:
        chain_id = int(upstream.call("eth_chainId", []), 16)
    spec = BY_CHAIN_ID[chain_id]
    return preflight_witness(upstream, block_number, spec)


class ProxyHandler(BaseHTTPRequestHandler):
    upstream: Upstream = None
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):   # route through print, not stderr spam
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        try:
            req = json.loads(body)
        except json.JSONDecodeError:
            return self._reply({"jsonrpc": "2.0", "id": None, "error": {
                "code": JSONRPC_INVALID, "message": "invalid json"}})
        method = req.get("method")
        if method == "debug_executionWitness":
            try:
                result = execution_witness(self.upstream, req["params"][0])
                return self._reply({"jsonrpc": "2.0", "id": req.get("id"),
                                    "result": result})
            except Exception as e:
                return self._reply({"jsonrpc": "2.0", "id": req.get("id"),
                                    "error": {"code": JSONRPC_INTERNAL,
                                              "message": str(e)}})
        try:
            raw = self.upstream.call_raw(body)
        except Exception as e:
            return self._reply({"jsonrpc": "2.0", "id": req.get("id"),
                                "error": {"code": JSONRPC_INTERNAL,
                                          "message": str(e)}})
        self._reply_raw(raw)

    def _reply(self, obj):
        self._reply_raw(json.dumps(obj).encode())

    def _reply_raw(self, raw: bytes):
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


def serve(upstream_url: str, bind: str = "127.0.0.1", port: int = 8545,
          max_retries: int = 10, backoff_ms: int = 200):
    """Run the proxy (crates/rpc-proxy/src/main.rs:237-245 equivalent)."""
    handler = type("BoundHandler", (ProxyHandler,), {
        "upstream": Upstream(upstream_url, max_retries, backoff_ms)})
    server = ThreadingHTTPServer((bind, port), handler)
    print(f"rpc-proxy listening on {bind}:{port} -> {upstream_url}")
    server.serve_forever()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="zeth-tpu-rpc-proxy")
    ap.add_argument("--rpc-url", required=True)
    ap.add_argument("--bind-address", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8545)
    ap.add_argument("--max-retries", type=int, default=10)
    ap.add_argument("--backoff-ms", type=int, default=200)
    a = ap.parse_args(argv)
    serve(a.rpc_url, a.bind_address, a.port, a.max_retries, a.backoff_ms)


if __name__ == "__main__":
    main()
