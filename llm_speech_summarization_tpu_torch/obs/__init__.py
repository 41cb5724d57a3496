"""Observability (port of ``obs/``): profiling helpers and the metrics writer."""

from .profile import annotate, trace
from .writer import MetricsWriter

__all__ = ["MetricsWriter", "annotate", "trace"]
