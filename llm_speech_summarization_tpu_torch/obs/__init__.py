"""Observability (port of ``obs/``): profiling helpers and the metrics writer."""

from .profile import StepTimer, annotate, trace
from .writer import MetricsWriter

__all__ = ["MetricsWriter", "StepTimer", "annotate", "trace"]
