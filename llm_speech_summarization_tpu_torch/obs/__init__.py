"""Observability (port of ``obs/``): the metrics writer."""
