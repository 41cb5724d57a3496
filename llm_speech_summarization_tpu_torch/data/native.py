"""ctypes bindings for the native (C++) host audio frontend: the two entry
points the server's audio decoding needs (a copy of the JAX package's
``data/native.py`` loader, cut to them).

Loads ``native/audio/libaudio_frontend.so`` at the repo root, building it
with ``make`` on first use when it is missing; each entry point has a
numpy/scipy version for a machine where the library cannot load.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from math import gcd
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "audio",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libaudio_frontend.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_lock = threading.Lock()  # HTTP handler threads decode audio concurrently


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lib_lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            if not os.path.exists(_LIB_PATH):
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.pcm16_to_f32_mono.argtypes = [
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.pcm16_to_f32_mono.restype = None
            lib.resample_sinc.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
            ]
            lib.resample_sinc.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError, AttributeError):
            _lib = None
        return _lib


def pcm16_to_f32_mono(pcm: np.ndarray) -> np.ndarray:
    """(frames,) or (frames, channels) int16 → (frames,) float32 mono."""
    pcm = np.ascontiguousarray(pcm, np.int16)
    frames = pcm.shape[0]
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    lib = _load()
    if lib is None:
        x = pcm.astype(np.float32) / 32768.0
        return x if channels == 1 else x.mean(axis=1)
    out = np.empty(frames, np.float32)
    lib.pcm16_to_f32_mono(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        frames,
        channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def resample(wav: np.ndarray, sr_in: int, sr_out: int, zero_crossings: int = 32) -> np.ndarray:
    """Windowed-sinc resample float32 mono audio."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    wav = np.ascontiguousarray(wav, np.float32)
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    n_out = int(len(wav) * up // down)
    lib = _load()
    if lib is None:
        from scipy.signal import resample_poly

        return resample_poly(wav, up, down).astype(np.float32)[:n_out]
    out = np.empty(n_out, np.float32)
    lib.resample_sinc(
        wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wav), up, down, zero_crossings,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_out,
    )
    return out
