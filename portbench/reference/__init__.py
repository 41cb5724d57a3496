"""The plain PyTorch reference the benchmark holds the program to: it
imports nothing of the program (``model.py``: the encoders, projector,
splice and decoder; ``kd.py``: the distillation step)."""
