"""The port's replica router (``serve/router.py``) on the CPU, as
``tests/test_router.py`` drives the JAX one: least-loaded pick, drain
ejection and recovery, streaming pass-through and the truncated-stream
record, over real HTTP in front of two port ``SummarizationServer``
replicas sharing one tiny CPU engine; and ``cli/route.py`` binding a free
port and naming it."""

import http.client
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.serve.router import ReplicaRouter
from llm_speech_summarization_tpu_torch.serve.server import SummarizationServer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def stack():
    engine = LLMSpeechTextInference(load_config(str(YAML_DIR / "tiny_test.yaml")), device="cpu")
    replicas = [
        SummarizationServer(engine, host="127.0.0.1", port=0, continuous=True, n_slots=2,
                            max_new_tokens=32, max_prompt_len=256, device="cpu")
        for _ in range(2)
    ]
    for r in replicas:
        r.start_background()
    router = ReplicaRouter([f"http://127.0.0.1:{r.port}" for r in replicas], host="127.0.0.1",
                           port=0, health_interval_s=3600)  # probed by hand
    router.start_background()
    yield router, replicas
    router.shutdown()
    for r in replicas:
        r.shutdown()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_router_balances_and_matches_direct(stack):
    router, replicas = stack
    rng = np.random.RandomState(11)
    wavs = [(0.05 * rng.randn(8000 + 300 * i)).astype(np.float32) for i in range(6)]
    # direct answers from a replica (one engine behind both: the same streams)
    want = [_post(replicas[0].port, "/v1/audio_summary",
                  {"audio": w.tolist(), "max_new_tokens": 8})[1]["response"] for w in wavs]
    results = [None] * 6

    def call(i):
        results[i] = _post(router.port, "/v1/audio_summary",
                           {"audio": wavs[i].tolist(), "max_new_tokens": 8})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    assert all(r[0] == 200 for r in results)
    assert [r[1]["response"] for r in results] == want
    m = router.metrics()
    assert m["served_total"] >= 6
    assert all(b["served"] > 0 for b in m["backends"])  # the burst reached both replicas


def test_router_streaming_passthrough(stack):
    router, _ = stack
    conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=300)
    conn.request("POST", "/v1/text_response",
                 json.dumps({"text": "route me", "max_new_tokens": 8, "stream": True}),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    assert resp.status == 200
    lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
    assert lines[-1]["done"] is True
    assert "".join(x.get("delta", "") for x in lines[:-1]) == lines[-1]["response"]


def test_router_ejects_draining_replica_and_recovers(stack):
    router, replicas = stack
    replicas[0]._draining = True  # /healthz answers 503: the router ejects it
    router.check_health_now()
    assert [b.healthy for b in router.backends] == [False, True]
    wav = (0.05 * np.random.RandomState(3).randn(8000)).astype(np.float32)
    before0, before1 = (b.served for b in router.backends)
    status, _ = _post(router.port, "/v1/audio_summary", {"audio": wav.tolist(),
                                                         "max_new_tokens": 4})
    # >=: a streamed request's count can land a beat after its client read it
    assert status == 200 and router.backends[1].served >= before1 + 1
    assert router.backends[0].served == before0  # the ejected replica saw nothing
    replicas[0]._draining = False  # recovery re-admits it
    router.check_health_now()
    assert [b.healthy for b in router.backends] == [True, True]
    for r in replicas:  # every replica draining: 503 from the router
        r._draining = True
    router.check_health_now()
    status, body = _post(router.port, "/v1/audio_summary", {"audio": wav.tolist(),
                                                            "max_new_tokens": 4})
    assert status == 503 and "no healthy backends" in body["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{router.port}/healthz", timeout=30)
    assert e.value.code == 503
    for r in replicas:
        r._draining = False
    router.check_health_now()


def test_router_flags_truncated_stream():
    """A replica dying mid-stream (the connection closes without a done or
    error record) surfaces as an {"error"} record and ejects the backend."""

    class DyingHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):  # /healthz: healthy until it dies
            body = b'{"status": "ok"}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for delta in (b'{"delta": "par"}\n', b'{"delta": "tial"}\n'):
                self.wfile.write(f"{len(delta):x}\r\n".encode() + delta + b"\r\n")
                self.wfile.flush()
            self.connection.close()  # no final record, no terminator

    backend = ThreadingHTTPServer(("127.0.0.1", 0), DyingHandler)
    threading.Thread(target=backend.serve_forever, daemon=True).start()
    router = ReplicaRouter([f"http://127.0.0.1:{backend.server_address[1]}"], host="127.0.0.1",
                           port=0, health_interval_s=3600)
    router.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", router.port, timeout=60)
        conn.request("POST", "/v1/text_response",
                     json.dumps({"text": "x", "max_new_tokens": 8, "stream": True}),
                     {"Content-Type": "application/json"})
        raw = conn.getresponse().read()
        conn.close()
        lines = [json.loads(x) for x in raw.splitlines() if x.strip()]
        assert lines[-1].get("error", "").startswith("upstream stream truncated")
        assert [x.get("delta") for x in lines[:-1]] == ["par", "tial"]
        b = router.backends[0]
        assert not b.healthy and b.errors == 1 and b.served == 0
    finally:
        router.shutdown()
        backend.shutdown()
        backend.server_close()


def test_route_cli_binds_a_free_port_and_names_it(stack):
    """``python -m ...cli.route --port 0`` prints the port it bound; the
    router there answers /healthz with both replicas, and loads neither
    jax nor torch."""
    _, replicas = stack
    backends = ",".join(f"http://127.0.0.1:{r.port}" for r in replicas)
    code = ("import sys, threading\n"
            "from llm_speech_summarization_tpu_torch.cli import route\n"
            "t = threading.Thread(target=route.main, args=(sys.argv[1:],), daemon=True)\n"
            "t.start()\n"
            "sys.stdin.readline()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torch', "
            "'llm_speech_summarization_tpu')), flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--backends", backends, "--host", "127.0.0.1", "--port",
         "0", "--health_interval", "3600"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("routing 2 replicas on 127.0.0.1:"), line
        port = int(line.rsplit(":", 1)[1])
        assert port > 0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        assert resp.status == 200
        assert [b["url"] for b in health["backends"]] == backends.split(",")
        out, _ = proc.communicate("\n", timeout=60)
        assert out.strip() == "[]"
    finally:
        proc.kill()
        proc.wait(timeout=30)
