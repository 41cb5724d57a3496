"""The port's host audio IO (``data/native.py``, ``data/flac.py``,
``data/audio_io.py``) against the JAX package's, on the same files: WAV in
int16, int32, uint8, float32 and stereo, resampled; FLAC through every
subframe type the fixture encoder writes, the native decoder against the
pure-Python one; batch padding; malformed input.

Tolerances: loaded audio bit-exact against the JAX loader (the same native
library and the same numpy arithmetic); decoders bit-exact against each
other; decoded FLAC within 1e-7 of the encoded int16 / 32768 (float32
rounding of the division).
"""

import numpy as np
import pytest
from flac_writer import encode_flac
from scipy.io import wavfile

from llm_speech_summarization_tpu.data import native as jax_native
from llm_speech_summarization_tpu.data.audio_io import load_audio as jax_load_audio
from llm_speech_summarization_tpu_torch.data import flac as pyflac
from llm_speech_summarization_tpu_torch.data import native
from llm_speech_summarization_tpu_torch.data.audio_io import load_audio


def _tone(n, seed=0, amp=8000):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = amp * np.sin(2 * np.pi * 220 * t / 16000) + rng.randint(-200, 200, n)
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


def _wav_data(kind, n=4000):
    x = _tone(n, seed=5)
    if kind == "int16":
        return 16000, x.astype(np.int16)
    if kind == "int32":
        return 16000, (x * 65536).astype(np.int32)
    if kind == "uint8":
        return 16000, (x // 256 + 128).astype(np.uint8)
    if kind == "float32":
        return 16000, (x / 32768.0).astype(np.float32)
    if kind == "stereo":
        return 16000, np.stack([x, _tone(n, seed=6)], 1).astype(np.int16)
    if kind == "stereo_int32":
        return 16000, np.stack([x, -x], 1).astype(np.int32) * 65536
    if kind == "resampled_48k":
        return 48000, _tone(3 * n, seed=7).astype(np.int16)
    raise KeyError(kind)


WAV_KINDS = ["int16", "int32", "uint8", "float32", "stereo", "stereo_int32", "resampled_48k"]


@pytest.mark.parametrize("kind", WAV_KINDS)
def test_load_wav_matches_jax(tmp_path, kind):
    sr, data = _wav_data(kind)
    p = tmp_path / f"{kind}.wav"
    wavfile.write(str(p), sr, data)
    got = load_audio(str(p), target_sr=16000)
    want = jax_load_audio(str(p), target_sr=16000)
    assert got.dtype == np.float32 and got.ndim == 1
    np.testing.assert_array_equal(got, want)
    if kind == "int16":
        np.testing.assert_allclose(got, data / 32768.0, atol=1e-7)
    if kind == "resampled_48k":
        assert abs(len(got) - len(data) // 3) <= 1


FLAC_CASES = [("verbatim", 0, 0), ("constant", 0, 0), ("fixed0", 0, 0), ("fixed1", 0, 0),
              ("fixed2", 0, 0), ("fixed3", 0, 0), ("fixed4", 0, 0), ("lpc", 0, 0),
              ("fixed2", 2, 0), ("fixed2", 0, 2), ("lpc", 0, 3)]


@pytest.mark.parametrize("mode,wasted,porder", FLAC_CASES)
def test_flac_native_matches_python_and_jax(mode, wasted, porder):
    """Each subframe type (wasted bits, 4 and 8 Rice partitions among them):
    the native decoder equals the pure-Python one and the JAX package's
    bindings, and gives back the encoded samples."""
    x = _tone(2500) if mode != "constant" else np.full(2500, 1234, np.int64)
    if wasted:
        x = (x >> wasted) << wasted
    data = encode_flac([x], blocksize=1024, mode=mode, wasted=wasted, porder=porder)
    got, sr = native.flac_decode(data)
    assert sr == 16000
    np.testing.assert_array_equal(got, pyflac.decode_f32_mono(data))
    want, want_sr = jax_native.flac_decode(data)
    np.testing.assert_array_equal(got, want)
    assert want_sr == sr
    np.testing.assert_allclose(got, x / 32768.0, atol=1e-7)


@pytest.mark.parametrize("mid_side", [False, True])
def test_flac_stereo_mixdown(mid_side):
    L, R = _tone(2048, seed=3), _tone(2048, seed=4)
    data = encode_flac([L, R], mode="fixed2", mid_side=mid_side)
    got, _ = native.flac_decode(data)
    np.testing.assert_array_equal(got, pyflac.decode_f32_mono(data))
    np.testing.assert_allclose(got, (L + R) / 2 / 32768.0, atol=1e-6)


def test_flac_unknown_length_info_and_corruption():
    x = _tone(1500)
    data = encode_flac([x], mode="fixed2", declared_total=0)
    got, _ = native.flac_decode(data)  # the sizing pass
    assert len(got) == 1500
    np.testing.assert_array_equal(got, pyflac.decode_f32_mono(data))
    stereo = encode_flac([x, x], sample_rate=24000)
    assert native.flac_info(stereo) == (1500, 24000, 2, 16) == jax_native.flac_info(stereo)
    bad = bytearray(encode_flac([_tone(1024)], mode="verbatim"))
    bad[len(bad) // 2] ^= 0xFF  # bits flipped inside a frame: CRC-16 mismatch
    with pytest.raises(ValueError):
        native.flac_decode(bytes(bad))
    with pytest.raises(ValueError):
        pyflac.decode_f32_mono(bytes(bad))


def test_load_flac_resampled_matches_jax(tmp_path):
    x = _tone(24000)
    p = tmp_path / "utt.flac"
    p.write_bytes(encode_flac([x], sample_rate=24000, mode="fixed2"))
    got = load_audio(str(p), target_sr=16000)
    np.testing.assert_array_equal(got, jax_load_audio(str(p), target_sr=16000))
    assert got.dtype == np.float32 and abs(len(got) - 16000) <= 2
    assert 0.5 < np.std(got) / np.std(x / 32768.0) < 1.5


def test_load_audio_dispatches_on_magic(tmp_path):
    """Content decides, not the extension; anything else is refused."""
    x = _tone(3000)
    flac_named_wav = tmp_path / "really_flac.wav"
    flac_named_wav.write_bytes(encode_flac([x], mode="fixed2"))
    np.testing.assert_allclose(load_audio(str(flac_named_wav)), x / 32768.0, atol=1e-7)
    p = tmp_path / "x.mp3"
    p.write_bytes(b"ID3\x04junkjunk")
    with pytest.raises(ValueError, match="unsupported audio container"):
        load_audio(str(p))


def test_pad_batch_and_pcm_match_jax():
    clips = [np.ones(5, np.float32), np.full(9, 2.0, np.float32), np.arange(3, dtype=np.float32)]
    out, lens = native.pad_batch(clips, 8)
    want, want_lens = jax_native.pad_batch(clips, 8)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(lens, want_lens)
    assert lens.tolist() == [5, 8, 3] and (out[0, 5:] == 0).all()
    pcm = np.array([[16384, -16384], [32767, 32767], [0, 0]], np.int16)
    np.testing.assert_array_equal(native.pcm16_to_f32_mono(pcm), jax_native.pcm16_to_f32_mono(pcm))
    assert native.native_available()
