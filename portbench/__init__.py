"""The port benchmark (see core.py)."""
