"""ctypes bindings for the native (C++) host audio frontend (a copy of the
JAX package's ``data/native.py``): PCM conversion, resampling, batch
padding and FLAC decoding, for the server's audio decoding and
``data/audio_io.py``.

Loads ``native/audio/libaudio_frontend.so`` at the repo root, building it
with ``make`` on first use when it is missing; each entry point has a
numpy/scipy (FLAC: ``data/flac.py``) version for a machine where the
library cannot load.
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
            lib.pad_batch_f32.argtypes = [
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ]
            lib.pad_batch_f32.restype = None
            lib.flac_info.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.flac_info.restype = ctypes.c_int
            lib.flac_decode_f32_mono.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
            lib.flac_decode_f32_mono.restype = ctypes.c_int64
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


def native_available() -> bool:
    return _load() is not None


def pad_batch(clips: list, n_out: int) -> tuple:
    """List of float32 clips → ((B, n_out) float32 right-padded, (B,) int32 lens)."""
    B = len(clips)
    lib = _load()
    clips = [np.ascontiguousarray(c, np.float32) for c in clips]
    if lib is None:
        out = np.zeros((B, n_out), np.float32)
        lens = np.zeros((B,), np.int32)
        for b, c in enumerate(clips):
            n = min(len(c), n_out)
            out[b, :n] = c[:n]
            lens[b] = n
        return out, lens
    out = np.empty((B, n_out), np.float32)
    lens = np.empty((B,), np.int32)
    ptrs = (ctypes.POINTER(ctypes.c_float) * B)(
        *[c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for c in clips]
    )
    clens = (ctypes.c_int64 * B)(*[len(c) for c in clips])
    lib.pad_batch_f32(
        ptrs, clens, B, n_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, lens


def flac_info(data: bytes):
    """(total_samples, sample_rate, channels, bps) from a FLAC stream."""
    lib = _load()
    if lib is None:
        from .flac import parse_streaminfo

        si = parse_streaminfo(data)
        return si.total_samples, si.sample_rate, si.channels, si.bps
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    total = ctypes.c_int64()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_info(buf, len(data), ctypes.byref(total), ctypes.byref(sr),
                       ctypes.byref(ch), ctypes.byref(bps))
    if rc != 0:
        raise ValueError("malformed FLAC stream")
    return total.value, sr.value, ch.value, bps.value


def flac_decode(data: bytes) -> tuple:
    """FLAC bytes → (float32 mono samples, sample_rate): the native decoder,
    or ``data/flac.py`` where the library cannot load."""
    lib = _load()
    if lib is None:
        from .flac import decode_f32_mono, parse_streaminfo

        si = parse_streaminfo(data)
        return decode_f32_mono(data), si.sample_rate
    total, sr, _, _ = flac_info(data)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    if total == 0:
        # STREAMINFO may omit the length: a sizing pass first
        total = lib.flac_decode_f32_mono(buf, len(data), None, 0)
        if total < 0:
            raise ValueError("malformed FLAC stream")
    out = np.empty(int(total), np.float32)
    n = lib.flac_decode_f32_mono(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(out)
    )
    if n < 0:
        raise ValueError("malformed FLAC stream (frame decode/CRC)")
    return out[:n], sr
