"""The device rule shared by the port's entry points: ``device=None`` means
the CUDA card, and a machine without one raises instead of running the
plain path; the plain (CPU) path runs only when the caller asks for it."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises RuntimeError when no card is visible);
    anything else as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is visible (torch.cuda.is_available() is false); pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


def check_engine_device(what: str, engine_device, device=None) -> torch.device:
    """Resolve ``device`` by the rule above and require the engine to live
    there (a serving layer never moves an engine)."""
    dev = resolve_device(device)
    if torch.device(engine_device).type != dev.type:
        raise ValueError(f"{what}: the engine lives on {engine_device}, not on {dev}")
    return dev
