"""Host-side audio IO (a copy of the JAX package's ``data/audio_io.py``).

WAV loading rides scipy for the container and the native frontend
(``data/native.py``) for PCM conversion and resampling; FLAC goes through
the native decoder (``data/flac.py`` where the library cannot load).
``load_audio`` dispatches on the file's magic bytes, not its extension.
"""

from __future__ import annotations

import numpy as np

from . import native


def load_wav(path: str, target_sr: int = 16000) -> np.ndarray:
    """A WAV file as mono float32 at ``target_sr`` (as librosa.load(path,
    sr=16000) gives it to the reference)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = native.pcm16_to_f32_mono(data)
    else:
        if data.dtype == np.int32:
            wav = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            wav = (data.astype(np.float32) - 128.0) / 128.0
        else:
            wav = data.astype(np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=1)
    if sr != target_sr:
        wav = native.resample(wav, sr, target_sr)
    return np.asarray(wav, np.float32)


def load_flac(path: str, target_sr: int = 16000) -> np.ndarray:
    """A FLAC file as mono float32 at ``target_sr`` (LibriSpeech ships FLAC)."""
    with open(path, "rb") as f:
        data = f.read()
    wav, sr = native.flac_decode(data)
    if sr != target_sr:
        wav = native.resample(wav, sr, target_sr)
    return np.asarray(wav, np.float32)


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """WAV or FLAC as mono float32 at ``target_sr``, by the file's magic
    bytes (extensions lie)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        return load_flac(path, target_sr)
    if magic == b"RIFF":
        return load_wav(path, target_sr)
    raise ValueError(f"unsupported audio container {magic!r} in {path} (WAV and FLAC supported)")
