"""Checkpoints in PyTorch's own format (port of ``train/checkpoint.py``,
which writes Orbax).

  * training checkpoints: ``<dir>/step_<n>/train_state.pt`` holding
    {enc_params, opt_state, step, epoch, epoch_step}; ``latest_checkpoint``
    finds the highest step. ``epoch_step`` counts the batches already
    consumed in ``epoch``: a resumed run skips them in its (seeded) epoch
    order and continues the exact batch sequence of an unbroken run;
  * encoder-only export (``export_encoder`` / ``load_encoder``) for
    inference, the reference's second format.

A save copies the tensors to host memory first; with ``block=False`` the
file is then written on a background thread while training goes on, one
save in flight at a time, and ``finalize_saves()`` waits for it. Files are
written under a temporary name and renamed, so a reader never sees half a
checkpoint.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional, Tuple

import torch

from .state import TrainState, tree_leaves, tree_map

STATE_FILE = "train_state.pt"
_pending: Optional[threading.Thread] = None
_pending_error: list = []


def _to_host(tree: Any) -> Any:
    def leaf(x):
        return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x

    return tree_map(leaf, tree) if isinstance(tree, (dict, list)) else leaf(tree)


def _write(payload: dict, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f".{STATE_FILE}.{os.getpid()}")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _write_in_background(payload, path):
    try:
        _write(payload, path)
    except BaseException as e:  # re-raised by finalize_saves
        _pending_error.append(e)


def finalize_saves() -> None:
    """Wait for the save in flight, if any, and raise what it raised."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def save_train_checkpoint(base_dir: str, step: int, epoch: int, state: TrainState,
                          block: bool = True, epoch_step: int = 0) -> str:
    global _pending
    path = os.path.join(os.path.abspath(base_dir), f"step_{step}")
    finalize_saves()  # one save in flight at a time
    payload = {
        "enc_params": _to_host(state.enc_params),
        "opt_state": {k: _to_host(v) for k, v in state.opt_state.items()},
        "step": int(step), "epoch": int(epoch), "epoch_step": int(epoch_step),
    }
    if block:
        _write(payload, path)
    else:
        _pending = threading.Thread(target=_write_in_background, args=(payload, path),
                                    daemon=True)
        _pending.start()
    return path


def latest_checkpoint(base_dir: str) -> Optional[str]:
    base = os.path.abspath(base_dir)
    if not os.path.isdir(base):
        return None
    steps = [int(m.group(1)) for name in os.listdir(base)
             if (m := re.fullmatch(r"step_(\d+)", name))
             and os.path.exists(os.path.join(base, name, STATE_FILE))]
    return os.path.join(base, f"step_{max(steps)}") if steps else None


def restore_train_checkpoint(path: str, template: TrainState) -> Tuple[dict, int, int]:
    """(payload, step, epoch); the payload's tensors are placed like the
    template's (its parameters' device; parameters float32 with
    requires_grad). The template gives the device, not the values."""
    device = tree_leaves(template.enc_params)[0].device
    raw = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    raw["enc_params"] = tree_map(lambda p: p.float().requires_grad_(), raw["enc_params"])
    return raw, int(raw["step"]), int(raw["epoch"])


def export_encoder(path: str, enc_params: Any) -> str:
    """Encoder-only export for inference: ``<path>`` is a file."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"enc_params": _to_host(enc_params)}, tmp)
    os.replace(tmp, path)
    return path


def load_encoder(path: str, device=None) -> Any:
    return torch.load(os.path.abspath(path), map_location=device, weights_only=True)["enc_params"]
