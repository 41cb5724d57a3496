"""The port's inference CLI on the CPU (``--device cpu``): one WAV or FLAC
prompt (``-a``), and a directory of both → JSONL (``--audio_dir``) through
the pipelined batch stream, each row equal to the per-file engine and to
the per-batch engine call on the loaded audio; the refusals (no card, a
checkpoint, a ``ctc_pool`` config, both or neither input).

Equality is exact: the same weights from the config's seed, the same
audio, the same float32 path.
"""

import json
import os

import numpy as np
import pytest
import torch
from flac_writer import encode_flac
from scipy.io import wavfile

from llm_speech_summarization_tpu_torch.cli import infer as cli_infer
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.data.audio_io import load_audio
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference

torch.set_num_threads(1)

TINY = str(YAML_DIR / "tiny_test.yaml")


def _corpus(d, n=5):
    """``n`` clips of 0.5-0.9 s, alternately WAV (int16) and FLAC."""
    d.mkdir()
    rng = np.random.RandomState(4)
    for i in range(n):
        pcm = np.clip(0.05 * rng.randn(8000 + 700 * i) * 32767, -32768, 32767).astype(np.int16)
        if i % 2:
            (d / f"utt{i}.flac").write_bytes(encode_flac([pcm.astype(np.int64)], mode="fixed2"))
        else:
            wavfile.write(str(d / f"utt{i}.wav"), 16000, pcm)
    return d


@pytest.fixture(scope="module")
def engine():
    return LLMSpeechTextInference(load_config(TINY), device="cpu")


@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_single_file(tmp_path, capsys, engine, ext):
    d = _corpus(tmp_path / "a", n=2)
    path = str(d / ("utt0.wav" if ext == "wav" else "utt1.flac"))
    eng = cli_infer.main(["-c", TINY, "-a", path, "--max_new_tokens", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    want = engine.generate_audio_response(load_audio(path), max_new_tokens=6)
    assert out == f"LLM Response:\n\n{want}\n"
    assert eng.counts["encoder_forwards"] == 1


def test_audio_dir_to_jsonl(tmp_path, engine):
    """Five clips in batches of 2 (WAV and FLAC mixed), sorted by size:
    rows in that order, each the per-file engine's response and the
    per-batch call's."""
    d = _corpus(tmp_path / "clips")
    out = tmp_path / "bulk.jsonl"
    eng = cli_infer.main(["-c", TINY, "--audio_dir", str(d), "--output", str(out),
                          "--batch_size", "2", "--max_new_tokens", "8", "--device", "cpu"])
    rows = [json.loads(line) for line in open(out)]
    paths = cli_infer.audio_paths(str(d))
    assert [r["file"] for r in rows] == paths and len(rows) == 5
    assert {os.path.splitext(p)[1] for p in paths} == {".wav", ".flac"}
    assert eng.counts["encoder_forwards"] == 3 and eng.counts["prefills"] == 3
    audio = [load_audio(p) for p in paths]
    for r, a in zip(rows, audio):
        assert r["response"] == engine.generate_audio_response(a, max_new_tokens=8)
    batched = [engine.generate_audio_response_batch(audio[i:i + 2], max_new_tokens=8)
               for i in range(0, 5, 2)]
    assert [r["response"] for r in rows] == [t for b in batched for t in b]


def test_refusals(tmp_path):
    d = _corpus(tmp_path / "r", n=1)
    wav = str(d / "utt0.wav")
    with pytest.raises(NotImplementedError, match=r"item 12\(a\)"):
        cli_infer.main(["-c", TINY, "-a", wav, "-p", "/ckpt", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_infer.main(["-c", TINY, "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_infer.main(["-c", TINY, "-a", wav, "--audio_dir", str(d), "--device", "cpu"])
    cfg_path = tmp_path / "ctc.yaml"
    cfg_path.write_text(open(TINY).read().replace("downsample_method: pool",
                                                  "downsample_method: ctc_pool"))
    with pytest.raises(NotImplementedError, match=r"item 12\(e\)"):
        cli_infer.main(["-c", str(cfg_path), "-a", wav, "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli_infer.main(["-c", TINY, "-a", wav])
