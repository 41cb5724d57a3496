"""Replica router (port of ``serve/router.py``): one HTTP endpoint in front
of N ``SummarizationServer`` replicas (``cli/serve.py``).

The 3B models fit one card with room, so the throughput deploy is one
server replica per card (or several on one card) behind this router: no
inter-card traffic, and each replica's own KV capacity. The router is
deliberately boring HTTP and holds no device code:

- **Least-loaded pick**: each backend carries an outstanding-request
  counter; new requests go to the healthy backend with the fewest in
  flight (ties: round-robin). Audio summarization requests differ 4-16x
  in decode budget, so least-loaded beats pure round-robin under mixed
  traffic.
- **Health ejection**: a background probe GETs each backend's /healthz;
  non-200 (including the 503 a draining replica returns) or no answer
  ejects it from rotation, and recovery re-admits it. A rolling restart of
  replicas is hitless: a drain (SIGTERM to ``cli/serve.py``) flips
  /healthz, the router deroutes, the replica finishes its in-flight work
  and exits.
- **Streaming pass-through**: ndjson token deltas re-chunk to the client
  line by line as they arrive from the replica; a replica that dies
  mid-stream ends the client's stream with an ``{"error"}`` record.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

# what a replica that is down or dying raises at the router
_UPSTREAM_ERRORS = (OSError, http.client.HTTPException)


class Backend:
    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        self.healthy = True
        self.outstanding = 0
        self.served = 0   # 2xx responses relayed (an error status passes uncounted)
        self.errors = 0   # transport failures (unreachable / died mid-stream)
        self.ejections = 0

    def snapshot(self) -> Dict:
        return {
            "url": self.base_url,
            "healthy": self.healthy,
            "outstanding": self.outstanding,
            "served": self.served,
            "errors": self.errors,
            "ejections": self.ejections,
        }


class ReplicaRouter:
    def __init__(
        self,
        backends: List[str],
        host: str = "0.0.0.0",
        port: int = 8000,
        health_interval_s: float = 2.0,
        request_timeout_s: float = 600.0,
    ):
        if not backends:
            raise ValueError("router needs at least one backend URL")
        self.backends = [Backend(b) for b in backends]
        self.health_interval_s = health_interval_s
        self.request_timeout_s = request_timeout_s
        self._rr = 0
        # guards every backend counter: handler threads update them at once
        self._lock = threading.Lock()
        self._stop = threading.Event()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet
                pass

            def _respond(self, code: int, obj: Dict):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    ok = any(b.healthy for b in outer.backends)
                    self._respond(200 if ok else 503, {
                        "status": "ok" if ok else "no healthy backends",
                        "backends": [b.snapshot() for b in outer.backends],
                    })
                elif self.path == "/metrics":
                    self._respond(200, outer.metrics())
                else:
                    self._respond(404, {"error": "not found"})

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                wants_stream = False
                try:  # routing only needs the stream flag; stay schema-blind
                    wants_stream = bool(json.loads(body or b"{}").get("stream"))
                except (ValueError, AttributeError):  # the replica answers 400
                    pass
                backend = outer._pick()  # arrives with outstanding += 1
                if backend is None:
                    self._respond(503, {"error": "no healthy backends"})
                    return
                try:
                    self._relay(backend, body, wants_stream)
                finally:
                    with outer._lock:
                        backend.outstanding -= 1

            def _relay(self, backend: Backend, body: bytes, wants_stream: bool):
                try:
                    req = urllib.request.Request(
                        backend.base_url + self.path, data=body,
                        headers={"Content-Type": "application/json"},
                    )
                    resp = urllib.request.urlopen(req, timeout=outer.request_timeout_s)
                except urllib.error.HTTPError as e:  # the replica's own answer
                    payload = e.read()
                    self.send_response(e.code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                except _UPSTREAM_ERRORS as e:  # the replica died since the pick
                    outer._eject(backend)
                    self._respond(502, {"error": f"backend {backend.base_url} unreachable: "
                                                 f"{type(e).__name__}: {e}"})
                    return
                with resp:
                    ctype = resp.headers.get("Content-Type", "application/json")
                    if not (wants_stream and "ndjson" in ctype):
                        payload = resp.read()
                        # count on upstream completion, before the client
                        # write: a client that reads the body and then
                        # inspects /metrics must see itself counted
                        with outer._lock:
                            backend.served += 1
                        self.send_response(resp.status)
                        self.send_header("Content-Type", ctype)
                        self.send_header("Content-Length", str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                        return
                    # re-chunk token deltas line by line as they arrive; a
                    # replica dying mid-stream must surface as an {"error"}
                    # record: readline() returning b'' on a dead socket would
                    # otherwise look like a clean, truncated stream
                    self.send_response(resp.status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def emit(raw: bytes):
                        self.wfile.write(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")
                        self.wfile.flush()

                    last = b""
                    try:
                        while True:
                            line = resp.readline()
                            if not line:
                                break
                            last = line
                            emit(line)
                        complete = b'"done"' in last or b'"error"' in last
                    except _UPSTREAM_ERRORS:
                        complete = False
                    if complete:
                        with outer._lock:
                            backend.served += 1
                    else:
                        outer._eject(backend)
                        emit(json.dumps({"error": "upstream stream truncated ("
                                                  f"{backend.base_url} died mid-stream)"}
                                        ).encode() + b"\n")
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()

        # a deep listen backlog, subclass-local so other ThreadingHTTPServers
        # in the process (co-hosted replicas in tests) keep their own
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128
            daemon_threads = True

        self.httpd = _Server((host, port), Handler)
        self._health_thread = threading.Thread(target=self._health_loop, daemon=True)
        self._health_thread.start()

    # ------------------------------------------------------------------

    def _pick(self) -> Optional[Backend]:
        """Healthy backend with the fewest outstanding requests; ties break
        round-robin so idle replicas share cold traffic evenly. The
        outstanding increment happens inside the lock: pick-then-increment-
        later lets a burst all read the same stale minimum and pile onto
        one replica."""
        with self._lock:
            healthy = [b for b in self.backends if b.healthy]
            if not healthy:
                return None
            lo = min(b.outstanding for b in healthy)
            pool = [b for b in healthy if b.outstanding == lo]
            self._rr = (self._rr + 1) % len(pool)
            picked = pool[self._rr]
            picked.outstanding += 1
            return picked

    def _eject(self, b: Backend) -> None:
        """A transport failure: out of rotation until a probe succeeds."""
        with self._lock:
            b.healthy = False
            b.ejections += 1
            b.errors += 1

    def _probe(self, b: Backend) -> bool:
        try:
            with urllib.request.urlopen(b.base_url + "/healthz", timeout=5) as r:
                return r.status == 200
        except _UPSTREAM_ERRORS:  # non-200 (HTTPError) or no answer: eject
            return False

    def _health_loop(self):
        while not self._stop.wait(self.health_interval_s):
            self.check_health_now()

    def check_health_now(self):
        """One synchronous probe sweep (tests; avoids interval races)."""
        for b in self.backends:
            ok = self._probe(b)
            with self._lock:
                if b.healthy and not ok:
                    b.ejections += 1
                b.healthy = ok

    def metrics(self) -> Dict:
        with self._lock:
            return {
                "backends": [b.snapshot() for b in self.backends],
                "healthy_count": sum(b.healthy for b in self.backends),
                "served_total": sum(b.served for b in self.backends),
            }

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._health_thread.join(timeout=10)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backends", required=True,
                   help="comma-separated replica base URLs, e.g. "
                        "http://10.0.0.1:8080,http://10.0.0.2:8080")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds a free port; the line printed at start names it")
    p.add_argument("--health_interval", type=float, default=2.0)
    args = p.parse_args(argv)
    router = ReplicaRouter(
        [b for b in args.backends.split(",") if b],
        host=args.host, port=args.port,
        health_interval_s=args.health_interval,
    )
    print(f"routing {len(router.backends)} replicas on {args.host}:{router.port}", flush=True)
    try:
        router.serve_forever()
    finally:
        router.shutdown()


if __name__ == "__main__":
    main()
