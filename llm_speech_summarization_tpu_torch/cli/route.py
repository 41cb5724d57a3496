"""Replica-router CLI: front N ``cli/serve.py`` replicas (one per card, or
several sharing one) with one least-loaded, health-ejecting HTTP endpoint.

Usage:
  python -m llm_speech_summarization_tpu_torch.cli.route \
      --backends http://10.0.0.1:8080,http://10.0.0.2:8080 --port 8000

``--port 0`` binds a free port; the line printed at start names it. A
rolling restart sends SIGTERM to one replica at a time: it drains (its
/healthz answers 503, so the router stops sending to it), finishes its
in-flight requests and exits, and the router re-admits its successor when
that answers /healthz.
"""

from ..serve.router import main

if __name__ == "__main__":
    main()
