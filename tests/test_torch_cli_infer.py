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
from collections import Counter

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


def test_audio_dir_to_jsonl(tmp_path, capsys, engine):
    """Five clips in batches of 2 (WAV and FLAC mixed), sorted by size:
    rows in that order, each the per-file engine's response and the
    per-batch call's; the batch stream's counters reported on stderr."""
    d = _corpus(tmp_path / "clips")
    out = tmp_path / "bulk.jsonl"
    eng = cli_infer.main(["-c", TINY, "--audio_dir", str(d), "--output", str(out),
                          "--batch_size", "2", "--max_new_tokens", "8", "--device", "cpu"])
    rows = [json.loads(line) for line in open(out)]
    paths = cli_infer.audio_paths(str(d))
    assert [r["file"] for r in rows] == paths and len(rows) == 5
    assert {os.path.splitext(p)[1] for p in paths} == {".wav", ".flac"}
    assert eng.counts["encoder_forwards"] == 3 and eng.counts["prefills"] == 3
    report = capsys.readouterr().err.splitlines()[-1]
    assert report == cli_infer.pipeline_report(eng.counts, Counter())
    assert report.startswith("3 batches, ") and f"; {eng.counts['decode_steps']} decode " in report
    assert report.endswith(", 0.0% replayed as CUDA graphs")  # the CPU runs no graph
    audio = [load_audio(p) for p in paths]
    for r, a in zip(rows, audio):
        assert r["response"] == engine.generate_audio_response(a, max_new_tokens=8)
    batched = [engine.generate_audio_response_batch(audio[i:i + 2], max_new_tokens=8)
               for i in range(0, 5, 2)]
    assert [r["response"] for r in rows] == [t for b in batched for t in b]


def test_refusals(tmp_path):
    """-p is ported (a missing file now raises FileNotFoundError, not the
    old NotImplementedError); a ctc_pool config without --ctc still stops,
    as the JAX CLI does; no card, both or neither input stop."""
    d = _corpus(tmp_path / "r", n=1)
    wav = str(d / "utt0.wav")
    with pytest.raises(FileNotFoundError, match="/ckpt"):
        cli_infer.main(["-c", TINY, "-a", wav, "-p", "/ckpt", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_infer.main(["-c", TINY, "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_infer.main(["-c", TINY, "-a", wav, "--audio_dir", str(d), "--device", "cpu"])
    cfg_path = tmp_path / "ctc.yaml"
    cfg_path.write_text(open(TINY).read().replace("downsample_method: pool",
                                                  "downsample_method: ctc_pool"))
    with pytest.raises(SystemExit):
        cli_infer.main(["-c", str(cfg_path), "-a", wav, "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli_infer.main(["-c", TINY, "-a", wav])


def test_checkpoints_and_ctc_match_jax_cli(tmp_path):
    """``-p`` and ``--ctc`` on a ``ctc_pool`` config with
    ``model.llm_checkpoint``: the port's CLI over a directory of clips
    against the JAX package's ``cli/infer.py`` over the same clips, each
    loading the same weights from its own format (Orbax there, the port's
    files here). Rows in the same file order; each clip's pool ranges equal
    to the JAX CTC function's; responses equal under the margin-aware
    contract."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp
    from torch_streams import assert_streams_agree, recorded_rows

    from llm_speech_summarization_tpu.cli import infer as jax_cli
    from llm_speech_summarization_tpu.configs import load_config as jax_load_config
    from llm_speech_summarization_tpu.data import preprocess as jpre
    from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
    from llm_speech_summarization_tpu.models import audio_encoder as jae
    from llm_speech_summarization_tpu.models import hubert as jhub
    from llm_speech_summarization_tpu.models import llama as jllama
    from llm_speech_summarization_tpu.train.checkpoint import export_encoder as jax_export
    from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
    from llm_speech_summarization_tpu_torch import bridge
    from llm_speech_summarization_tpu_torch.data.preprocess import (
        load_ctc_fn,
        pool_ranges_for_audio,
    )
    from llm_speech_summarization_tpu_torch.train.checkpoint import export_encoder, save_params
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    def np_tree(t):
        return bridge.params_from_numpy(jax.tree.map(np.asarray, t))

    def orbax_save(path, payload):
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(str(path), payload, force=True)
        ckptr.wait_until_finished()
        return str(path)

    jyaml_src = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                             "configs", "yaml", "tiny_test.yaml")
    llm = jllama.init_llama_params(jax.random.PRNGKey(0), jllama.llama_preset("tiny"),
                                   dtype=jnp.float32)
    jllm = orbax_save(tmp_path / "jllm", {"llm_params": llm})
    tllm = save_params(str(tmp_path / "llm.pt"), {"llm_params": np_tree(llm)})
    yamls = {}
    for name, src, ckpt in (("jax", jyaml_src, jllm), ("port", TINY, tllm)):
        text = open(src).read().replace("downsample_method: pool", "downsample_method: ctc_pool")
        text = text.replace("  llm_preset: tiny\n", f"  llm_preset: tiny\n  llm_checkpoint: {ckpt}\n")
        yamls[name] = tmp_path / f"{name}.yaml"
        yamls[name].write_text(text)
    jcfg = jax_load_config(str(yamls["jax"]))
    enc = jae.init_audio_encoder(jax.random.PRNGKey(1), jae.encoder_setup_from_config(jcfg),
                                 dtype=jnp.float32)
    jenc = jax_export(str(tmp_path / "jenc"), enc)
    tenc = export_encoder(str(tmp_path / "enc.pt"), np_tree(enc))
    hcfg = jhub.hubert_preset("tiny")
    ctc = {"enc_params": jhub.init_hubert_params(jax.random.PRNGKey(7), hcfg, dtype=jnp.float32),
           "head_params": jhub.init_hubert_ctc_head(jax.random.PRNGKey(8), hcfg, 32,
                                                    dtype=jnp.float32)}
    ctc["head_params"]["ctc_w"] = ctc["head_params"]["ctc_w"] * 40.0
    jctc = orbax_save(tmp_path / "jctc", ctc)
    tctc = save_params(str(tmp_path / "ctc.pt"), {k: np_tree(v) for k, v in ctc.items()})

    d = _corpus(tmp_path / "clips")
    common = ["--ctc_preset", "tiny", "--audio_dir", str(d), "--batch_size", "2",
              "--max_new_tokens", "8"]
    with recorded_rows(JaxByteTokenizer) as jrows:
        jax_cli.main(["-c", str(yamls["jax"]), "-p", jenc, "--ctc", jctc, "--output",
                      str(tmp_path / "jax.jsonl")] + common)
    with recorded_rows(ByteTokenizer) as trows:
        eng = cli_infer.main(["-c", str(yamls["port"]), "-p", tenc, "--ctc", tctc, "--output",
                              str(tmp_path / "port.jsonl"), "--device", "cpu"] + common)
    want = [json.loads(x) for x in open(tmp_path / "jax.jsonl")]
    got = [json.loads(x) for x in open(tmp_path / "port.jsonl")]
    assert [r["file"] for r in got] == [r["file"] for r in want] and len(got) == 5
    assert eng.counts["encoder_forwards"] == 3
    audio = [load_audio(r["file"]) for r in got]
    jfn = jpre.load_ctc_fn(jctc, "tiny", 32)
    tfn = load_ctc_fn(tctc, "tiny", 32, device="cpu")
    ranges = [pool_ranges_for_audio(tfn, a) for a in audio]
    for a, r in zip(audio, ranges):
        np.testing.assert_array_equal(r, jpre.pool_ranges_for_audio(jfn, a))
    assert sum(len(r) for r in ranges) > 5  # words found, not the [(0, 1)] fallback
    je = []

    def prompt_of(i):
        if not je:
            je.append(JaxEngine(jcfg, audio_encoder_checkpoint=jenc))
        e, m = je[0].build_audio_prompt_batch([audio[i]], ctc_pool_ranges=[ranges[i]])
        return je[0], np.asarray(e)[:1], np.asarray(m)[:1]

    assert_streams_agree(jrows, trows, prompt_of)
    for g, w, a, b in zip(got, want, jrows, trows):
        if a == b:
            assert g["response"] == w["response"]
