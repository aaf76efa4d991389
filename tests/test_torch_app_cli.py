"""The port's front door against zeth_tpu's: the CLI, ``BlockProcessor``,
``run_parallel`` and the RPC proxy, on block 101.

Block 101 is test_app's synthetic block (no transactions, stand-in
EIP-7002/7251 contracts): its guest runs in one segment plus a keccak
batch. Its input is committed as tests/fixtures/cli/input_0x<hash>.json
(a directory of its own: the two full fixture blocks' glob must not
match it) for ``chip_smoke.py``, which proves it on the card through the
CLI; a test holds the file equal to ``_fixture_input()``. Here the CLI
validates and proves in dev mode (``ZETH_DEV_MODE=1``); the dev-mode
receipt, the image ID and the run_parallel CSV must equal the JAX
package's. With ZETH_E2E=1 the block is STARK-proved on the CPU at
segment_po2=14 (test_guest_stateless's real-proof case).
"""

import csv
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import test_app as JA

from zeth_tpu.app import host as JH
from zeth_tpu_torch.app import cli as TCLI
from zeth_tpu_torch.app import host as TH

E2E = os.environ.get("ZETH_E2E", "0") == "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_FIXTURE = os.path.join(
    ROOT, "tests", "fixtures", "cli",
    "input_0x26e16f7cc35271416e74de3cf7cd947ebcea88ac390f9d3a8e700993b68394e9"
    ".json")


@pytest.fixture
def cache(tmp_path):
    """A cache directory holding the committed block-101 input."""
    shutil.copy(CLI_FIXTURE, tmp_path)
    return tmp_path


def test_committed_cli_input_equals_the_jax_helper():
    d, block = JA._fixture_input()
    with open(CLI_FIXTURE) as f:
        assert json.load(f) == d
    assert os.path.basename(CLI_FIXTURE) == f"input_0x{block.hash().hex()}.json"
    assert TH.StatelessInput.from_json(d).block.hash() == block.hash()


def test_cli_validate_and_dev_prove(cache, monkeypatch, capsys):
    monkeypatch.delenv("ZETH_DEV_MODE", raising=False)
    assert TCLI.main(["--cache-dir", str(cache), "--block", "101",
                      "validate"]) == 0
    out = capsys.readouterr().out
    assert "hash 0x26e16f7cc352" in out and "loading cached input" in out
    monkeypatch.setenv("ZETH_DEV_MODE", "1")
    assert TCLI.main(["--cache-dir", str(cache), "--block", "101",
                      "prove"]) == 0
    assert "receipt verified; journal matches block hash" in \
        capsys.readouterr().out


def test_cli_exit_codes_equal_reference(tmp_path, capsys):
    """No cached input and no RPC URL: both CLIs exit 1."""
    from zeth_tpu.app import cli as JCLI
    args = ["--cache-dir", str(tmp_path), "--block", "7", "validate"]
    assert TCLI.main(args) == JCLI.main(args) == 1
    assert "no cached input" in capsys.readouterr().err


def test_dev_mode_block_receipt_equals_reference(monkeypatch):
    """``BlockProcessor.prove`` in dev mode: the journal, the claim and the
    cycle stats of the JAX package's receipt, and the image ID that
    ``image_id()`` computes from the guest ELF."""
    monkeypatch.setenv("ZETH_DEV_MODE", "1")
    d, block = JA._fixture_input()
    tp, jp = TH.BlockProcessor.for_chain_id(1), JH.BlockProcessor.for_chain_id(1)
    got = tp.prove(TH.StatelessInput.from_json(d))
    want = jp.prove(JH.StatelessInput.from_json(d))
    assert got.journal == want.journal == block.hash()
    np.testing.assert_array_equal(got.claim.image_id, want.claim.image_id)
    assert got.claim.journal_digest == want.claim.journal_digest
    assert got.claim.exit_code == want.claim.exit_code == 0
    assert got.stats.__dict__ == want.stats.__dict__
    assert got.stats.segments == 1 and got.stats.keccak_calls > 0
    image_id = tp.image_id()
    np.testing.assert_array_equal(image_id, jp.image_id())
    np.testing.assert_array_equal(image_id, got.claim.image_id)
    got.verify(image_id)


def _run_parallel(module: str, cache, out) -> list:
    """One package's run_parallel in a process of its own (its pool forks,
    and a forked child must not inherit an initialised CUDA context)."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    env.pop("ZETH_DEV_MODE", None)          # dev mode is its default
    proc = subprocess.run(
        [sys.executable, "-m", module, "--jobs", "1", "--cache-dir",
         str(cache), "--output", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out) as f:
        return list(csv.DictReader(f))


def test_run_parallel_csv_equals_reference(cache, tmp_path):
    got = _run_parallel("zeth_tpu_torch.app.run_parallel", cache,
                        tmp_path / "port.csv")
    want = _run_parallel("zeth_tpu.app.run_parallel", cache,
                         tmp_path / "jax.csv")
    assert len(got) == len(want) == 1 and got[0]["block_number"] == "101"
    for row in (got, want):
        for r in row:
            assert r.pop("execution_time").endswith("ms")
    assert got == want


def test_rpc_proxy_forwards_and_serves_witness():
    """test_app's proxy case against the port's module: a local fake
    upstream, every method forwarded, the witness served."""
    import threading
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from zeth_tpu_torch.app import rpc_proxy

    calls = []

    class FakeUpstream(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            calls.append(body["method"])
            result = {"debug_executionWitness": {
                "state": ["0xdead"], "codes": [], "keys": [], "headers": []},
                "eth_chainId": "0x1"}.get(body["method"])
            raw = json.dumps({"jsonrpc": "2.0", "id": body["id"],
                              "result": result}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    up = ThreadingHTTPServer(("127.0.0.1", 0), FakeUpstream)
    threading.Thread(target=up.serve_forever, daemon=True).start()
    handler = type("H", (rpc_proxy.ProxyHandler,), {
        "upstream": rpc_proxy.Upstream(
            f"http://127.0.0.1:{up.server_address[1]}", max_retries=1)})
    proxy = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=proxy.serve_forever, daemon=True).start()

    def call(method, params):
        req = urllib.request.Request(
            f"http://127.0.0.1:{proxy.server_address[1]}",
            data=json.dumps({"jsonrpc": "2.0", "id": 7, "method": method,
                             "params": params}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.load(resp)

    try:
        assert call("eth_chainId", [])["result"] == "0x1"
        out = call("debug_executionWitness", ["0x64"])
        assert out["result"]["state"] == ["0xdead"]
        assert "eth_chainId" in calls and "debug_executionWitness" in calls
    finally:
        up.shutdown()
        proxy.shutdown()


@pytest.mark.skipif(not E2E, reason="slow e2e (set ZETH_E2E=1): a real "
                    "STARK prove of every segment on the CPU")
def test_block_processor_real_prove_on_cpu(monkeypatch):
    """test_guest_stateless's real-proof case through the port: every
    segment and the keccak batch STARK-proved on the CPU, the receipt
    verified against ``image_id()`` and the journal against the hash."""
    monkeypatch.delenv("ZETH_DEV_MODE", raising=False)
    d, block = JA._fixture_input()
    proc = TH.BlockProcessor.for_chain_id(1)
    receipt = proc.prove(TH.StatelessInput.from_json(d), segment_po2=14,
                         device="cpu")
    assert receipt.inner.kind == "segments" and \
        receipt.inner.keccak_seal is not None
    receipt.verify(proc.image_id(), device="cpu")
    assert receipt.journal == block.hash()
