"""The device rule shared by the port's entry points: ``device=None`` means
the CUDA card, and a machine without one raises instead of running the
plain path; the plain (CPU) path runs only when the caller asks for it."""

from __future__ import annotations

import contextlib
import threading

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


_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved = None


@contextlib.contextmanager
def exact_float32(x: torch.Tensor):
    """Where ``x`` is a float32 CUDA tensor, the block's float32 products and
    cuDNN convolutions run in float32, not TF32 (cuDNN's default), as the
    JAX package asks for ``Precision.HIGHEST`` at float32. The settings from
    before the outermost such block come back after it: the blocks are
    counted under a lock, since the server's prompt builder and scheduler
    threads enter them at once and the settings are the process's."""
    global _tf32_depth, _tf32_saved
    if not (x.is_cuda and x.dtype == torch.float32):
        yield
        return
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.set_float32_matmul_precision(_tf32_saved[0])
                torch.backends.cudnn.allow_tf32 = _tf32_saved[1]
