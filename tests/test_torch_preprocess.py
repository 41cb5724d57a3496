"""The port's offline preprocessing against the JAX package's on the CPU.

``preprocess_examples`` over the same raw examples with the same weights
(the JAX engine's LLM and encoder and a random tiny HuBERT-CTC model, moved
to the port through ``bridge.py``): token ids, word offsets and pool ranges
equal, the 20 s filter the same, and the responses equal under the
margin-aware contract (``torch_streams.py``). Then the mirrors of
``tests/test_preprocess.py`` (CTC collapse, word offsets, pool ranges,
the streamed save with bounded memory, read back by the port's
``HFDiskDataset``) and of ``tests/test_flac.py``'s LibriSpeech tree, the CTC
function's buckets, ``cli/preprocess.py`` end to end, and the refusal to
save without ``datasets``.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flac_writer import encode_flac
from torch_streams import assert_streams_agree, recorded_rows

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.data import preprocess as jpre
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.data import preprocess as tpre
from llm_speech_summarization_tpu_torch.data.datasets import (
    HFDiskDataset,
    LazyRawView,
    load_librispeech_dir,
)
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.train import checkpoint as tckpt
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

torch.set_num_threads(2)

TINY = str(YAML_DIR / "tiny_test.yaml")
JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")
WORDS = "the quick brown fox jumps over a lazy dog near the river".split()


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ctc_weights():
    """A random tiny HuBERT-CTC model (JAX init, float32) whose head favours
    the blank and the word delimiter enough that clips collapse into a few
    words."""
    cfg = jhub.hubert_preset("tiny")
    enc = jhub.init_hubert_params(jax.random.PRNGKey(7), cfg, dtype=jnp.float32)
    head = jhub.init_hubert_ctc_head(jax.random.PRNGKey(8), cfg, 32, dtype=jnp.float32)
    head = dict(head, ctc_w=head["ctc_w"] * 40.0)
    return cfg, np_tree(enc), np_tree(head)


def _examples(n=6, long_index=2):
    rng = np.random.RandomState(11)
    out = []
    for i in range(n):
        secs = 21.0 if i == long_index else rng.uniform(0.6, 2.0)
        wav = (0.1 * rng.randn(int(secs * 16000))).astype(np.float32)
        text = " ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 9)))
        out.append({"audio": wav, "text": text.upper() if i % 2 else text})
    return out


@pytest.fixture(scope="module")
def engines():
    je = JaxEngine(jax_load_config(JAX_TINY))
    te = LLMSpeechTextInference(
        load_config(TINY), device="cpu",
        llm_params=bridge.params_from_numpy(np_tree(je.llm_params)),
        audio_encoder_params=bridge.params_from_numpy(np_tree(je.audio_encoder_params)))
    return je, te


def _batch_rows(rows, texts, tok, template, batch_size):
    """Recorded decode rows (padded batches, in length-sorted batch order)
    → the real rows, indexed like ``texts``."""
    lens = [len(tok.encode(template.full_text_prompt(t.lower()))) for t in texts]
    order = sorted(range(len(texts)), key=lambda i: lens[i])
    out, pos = [None] * len(texts), 0
    for i in range(0, len(order), batch_size):
        idx = order[i: i + batch_size]
        padded = 1 << (len(idx) - 1).bit_length()
        for j, r in zip(idx, rows[pos: pos + len(idx)]):
            out[j] = r
        pos += padded
    assert pos == len(rows)
    return out


def test_preprocess_rows_match_jax(engines):
    je, te = engines
    cfg, enc, head = _ctc_weights()
    jctc = jpre.make_ctc_fn(jax.tree.map(jnp.asarray, enc), jax.tree.map(jnp.asarray, head), cfg)
    from llm_speech_summarization_tpu_torch.models import hubert as thub

    tctc = tpre.make_ctc_fn(bridge.params_from_numpy(enc), bridge.params_from_numpy(head),
                            thub.hubert_preset("tiny"))
    ex = _examples()
    kw = dict(max_seconds=20.0, response_batch_size=4)
    with recorded_rows(JaxByteTokenizer) as jrows:
        want = jpre.preprocess_examples(ex, je, je.tokenizer, ctc_fn=jctc, **kw)
    with recorded_rows(ByteTokenizer) as trows:
        got = tpre.preprocess_examples(ex, te, te.tokenizer, ctc_fn=tctc, **kw)
    assert len(got) == len(want) == len(ex) - 1  # the 21 s clip is dropped
    kept = [e["text"] for i, e in enumerate(ex) if i != 2]
    n_words = 0
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["audio"], w["audio"])
        assert g["hubert_word_offsets"] == w["hubert_word_offsets"]
        np.testing.assert_array_equal(g["pool_ranges_4"], w["pool_ranges_4"])
        assert g["pool_ranges_4"].dtype == np.int32 and g["pool_ranges_4"].shape[1] == 2
        np.testing.assert_array_equal(g["text_input_ids"], w["text_input_ids"])
        n_words += len(g["hubert_word_offsets"])
    assert n_words >= len(got)  # the CTC model found words
    jr = _batch_rows(jrows, kept, je.tokenizer, je.template, 4)
    tr = _batch_rows(trows, kept, te.tokenizer, te.template, 4)

    def prompt_of(i):
        embeds, mask = je.build_text_prompt_batch([kept[i].lower()])
        return je, np.asarray(embeds)[:1], np.asarray(mask)[:1]

    assert_streams_agree(jr, tr, prompt_of)
    for g, w, a, b in zip(got, want, jr, tr):
        if a == b:  # same stream: same text and ids
            assert g["llm_response"] == w["llm_response"]
            np.testing.assert_array_equal(g["response_input_ids"], w["response_input_ids"])


def test_ctc_fn_buckets_and_empty_clip():
    """Clips pad to whole seconds (at least one) and the argmax runs over
    the valid frames: a 0.3 s clip and the same clip inside 1 s of zeros
    past its end give the same ids; a clip without words maps to one range
    [0, 1)."""
    from llm_speech_summarization_tpu_torch.models import hubert as thub

    cfg, enc, head = _ctc_weights()
    tctc = tpre.make_ctc_fn(bridge.params_from_numpy(enc), bridge.params_from_numpy(head),
                            thub.hubert_preset("tiny"))
    jctc = jpre.make_ctc_fn(jax.tree.map(jnp.asarray, enc), jax.tree.map(jnp.asarray, head), cfg)
    wav = (0.1 * np.random.RandomState(0).randn(4800)).astype(np.float32)
    for n in (4800, 16000, 20000):
        clip = np.concatenate([wav, np.zeros(max(n - len(wav), 0), np.float32)])[:n]
        g, w = tctc(clip), jctc(clip)
        assert g[1:] == w[1:] == (0, 4)
        np.testing.assert_array_equal(g[0], w[0])
        assert len(g[0]) == thub.hubert_frame_count(thub.hubert_preset("tiny"), n)
    blank = lambda a: (np.zeros(40, np.int64), 0, 4)  # noqa: E731
    np.testing.assert_array_equal(tpre.pool_ranges_for_audio(blank, wav), [[0, 1]])
    got = tpre.pool_ranges_for_audio(tctc, wav)
    want = jpre.pool_ranges_for_audio(jctc, wav)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_load_ctc_fn_reads_the_converted_file(tmp_path):
    from llm_speech_summarization_tpu_torch.models import hubert as thub

    _, enc, head = _ctc_weights()
    path = tckpt.save_params(str(tmp_path / "ctc.pt"), {
        "enc_params": bridge.params_from_numpy(enc), "head_params": bridge.params_from_numpy(head)})
    fn = tpre.load_ctc_fn(path, preset="tiny", vocab_size=32, device="cpu")
    ref = tpre.make_ctc_fn(bridge.params_from_numpy(enc), bridge.params_from_numpy(head),
                           thub.hubert_preset("tiny"))
    wav = (0.1 * np.random.RandomState(1).randn(12000)).astype(np.float32)
    np.testing.assert_array_equal(fn(wav)[0], ref(wav)[0])
    with pytest.raises(ValueError, match="CTC head"):
        tpre.load_ctc_fn(path, preset="tiny", vocab_size=31, device="cpu")


# ------------------------------------------ mirrors of tests/test_preprocess.py


def test_ctc_collapse():
    pred = np.array([0, 3, 3, 0, 5, 5, 5, 0, 0, 3])
    got = tpre.ctc_collapse_with_offsets(pred, blank_id=0)
    assert got == [(3, 1, 3), (5, 4, 7), (3, 9, 10)] == jpre.ctc_collapse_with_offsets(pred, 0)


def test_word_offsets():
    pred = np.array([1, 1, 0, 2, 4, 4, 3, 3, 0])
    words = tpre.word_offsets_from_ctc(pred, blank_id=0, word_delim_id=4)
    assert words == [{"start_offset": 0, "end_offset": 4}, {"start_offset": 6, "end_offset": 8}]
    assert words == jpre.word_offsets_from_ctc(pred, 0, 4)


@pytest.mark.parametrize("seed", range(4))
def test_pool_ranges_match_jax(seed):
    rng = np.random.RandomState(seed)
    words, t = [], int(rng.randint(0, 6))
    for _ in range(rng.randint(1, 8)):
        s = t + int(rng.randint(0, 3))  # gaps of 0 (adjacent words) allowed
        t = s + int(rng.randint(1, 12))
        words.append({"start_offset": s, "end_offset": t})
    for width in (2, 4):
        assert tpre.get_ctc_pool_ranges(words, width) == jpre.get_ctc_pool_ranges(words, width)


def test_pool_ranges_empty():
    assert tpre.get_ctc_pool_ranges([]) == []


_RSS_SCRIPT = r"""
import json, resource, sys

sys.path.insert(0, sys.argv[1])
import numpy as np

from llm_speech_summarization_tpu_torch.data.datasets import LazyRawView
from llm_speech_summarization_tpu_torch.data.preprocess import (
    iter_preprocess_examples,
    save_preprocessed,
)
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer


class _Template:
    def full_text_prompt(self, t):
        return "summarize: " + t


class _FakeEngine:  # step 1 stub: the LLM does not matter to the memory contract
    def __init__(self):
        self.tokenizer = ByteTokenizer()
        self.template = _Template()

    def generate_text_response_batch(self, texts, max_new_tokens):
        return ["response to " + t[:16] for t in texts]


N, SAMPLES = int(sys.argv[3]), int(sys.argv[4])


def _get(i):
    wav = np.full(SAMPLES, 0.001 * (i + 1), np.float32)
    wav[:8] = np.float32(i)  # per-row fingerprint
    return {"audio": wav, "text": f"utterance number {i}"}


rows = iter_preprocess_examples(LazyRawView(N, _get), _FakeEngine(), ByteTokenizer(),
                                max_seconds=1e9)
n = save_preprocessed(rows, sys.argv[2], sampling_rate=16000, writer_batch_size=8)
peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
print(json.dumps({"n_written": n, "peak_mb": peak_mb}))
"""


def test_streaming_save_bounded_rss(tmp_path):
    """96 x 8 MB waveforms (768 MB of audio) stream through
    iter_preprocess_examples -> save_preprocessed in a subprocess whose peak
    RSS grows by less than 350 MB over the same job on 2 rows (imports and
    allocator arenas cancel); the split reads back through ``load_from_disk``
    and the port's ``HFDiskDataset`` (BOS stripped)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rss_job.py"
    script.write_text(_RSS_SCRIPT)

    def run(n_rows, out_name):
        r = subprocess.run([sys.executable, str(script), repo, str(tmp_path / out_name),
                            str(n_rows), "2000000"], capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        assert stats["n_written"] == n_rows
        return stats["peak_mb"]

    base_mb = run(2, "out_tiny")
    full_mb = run(96, "split")
    assert full_mb - base_mb < 350, (base_mb, full_mb)

    from datasets import load_from_disk

    back = load_from_disk(str(tmp_path / "split"))
    assert len(back) == 96
    row = back[7]
    assert row["audio"]["sampling_rate"] == 16000 and row["pool_ranges_4"] == []
    assert row["llm_response"].startswith("response to ")
    ds = HFDiskDataset(str(tmp_path), ["split"])
    ex = ds[7]
    assert ex["audio"].dtype == np.float32 and ex["audio"][0] == 7.0
    assert ex["audio"].shape == (2000000,)
    assert ex["text_input_ids"].tolist() == ByteTokenizer().encode("utterance number 7",
                                                                  add_bos=False)


def test_save_without_datasets_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    rows = iter([{"audio": np.zeros(4, np.float32)}])
    with pytest.raises(ImportError, match="`datasets`"):
        tpre.save_preprocessed(rows, str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def _tone(n, seed=0, amp=8000):
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    x = amp * np.sin(2 * np.pi * 220 * t / 16000) + rng.randint(-200, 200, n)
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


def _librispeech_tree(root, n=3):
    d = root / "19" / "198"
    d.mkdir(parents=True)
    waves, lines = {}, []
    for i in range(n):
        utt = f"19-198-{i:04d}"
        x = _tone(1600 + 300 * i, seed=i)
        (d / f"{utt}.flac").write_bytes(encode_flac([x], mode="fixed2"))
        waves[utt] = x
        lines.append(f"{utt} HELLO WORLD {i}")
    (d / "19-198.trans.txt").write_text("\n".join(lines))
    # an orphan audio file without transcript is skipped
    (d / "19-198-9999.flac").write_bytes(encode_flac([_tone(800)], mode="fixed2"))
    return waves


def test_librispeech_dir_ingestion(tmp_path):
    """spk/chap/spk-chap-utt.flac + trans.txt: lazy {audio, text} examples
    in id order, the orphan skipped, ``limit`` honoured; a tree without
    audio gives None."""
    from llm_speech_summarization_tpu.data import load_librispeech_dir as jload

    waves = _librispeech_tree(tmp_path)
    ex = load_librispeech_dir(str(tmp_path))
    assert [e["text"] for e in ex] == [f"HELLO WORLD {i}" for i in range(3)]
    for i, (e, w) in enumerate(zip(ex, jload(str(tmp_path)))):
        np.testing.assert_allclose(e["audio"], waves[f"19-198-{i:04d}"] / 32768.0, atol=1e-7)
        np.testing.assert_array_equal(e["audio"], w["audio"])
    assert [e["text"] for e in load_librispeech_dir(str(tmp_path), limit=2)] == \
        ["HELLO WORLD 0", "HELLO WORLD 1"]
    empty = tmp_path / "empty"
    empty.mkdir()
    assert load_librispeech_dir(str(empty)) is None
    view = LazyRawView(3, lambda i: {"audio": np.zeros(i + 1, np.float32), "text": str(i)})
    assert len(view) == 3 and [e["text"] for e in view] == ["0", "1", "2"]


@pytest.mark.parametrize("source", ["synthetic", "librispeech", "hf_disk"])
def test_preprocess_cli(tmp_path, source):
    """``cli/preprocess.py --device cpu`` on the tiny config with ``--ctc``:
    every input kind streams to a split that ``HFDiskDataset`` reads back
    with word offsets and pool ranges."""
    from llm_speech_summarization_tpu_torch.cli import preprocess as cli

    _, enc, head = _ctc_weights()
    ctc = tckpt.save_params(str(tmp_path / "ctc.pt"), {
        "enc_params": bridge.params_from_numpy(enc), "head_params": bridge.params_from_numpy(head)})
    args = ["-c", TINY, "--output", str(tmp_path / "out" / "split"), "--device", "cpu",
            "--ctc", ctc, "--ctc_preset", "tiny", "--batch_size", "2"]
    if source == "synthetic":
        args += ["--synthetic", "3"]
        n = 3
    elif source == "librispeech":
        _librispeech_tree(tmp_path / "ls")
        args += ["--input", str(tmp_path / "ls"), "--limit", "2"]
        n = 2
    else:
        rows = [{"audio": (0.1 * np.random.RandomState(i).randn(9000)).astype(np.float32),
                 "text": f"clip {i}", "text_input_ids": [1], "llm_response": "",
                 "response_input_ids": [1], "hubert_word_offsets": [],
                 "pool_ranges_4": np.zeros((0, 2), np.int32)} for i in range(3)]
        tpre.save_preprocessed(rows, str(tmp_path / "raw"))
        args += ["--input", str(tmp_path / "raw")]
        n = 3
    assert cli.main(args) == n
    ds = HFDiskDataset(str(tmp_path / "out"), ["split"])
    assert len(ds) == n
    for i in range(n):
        ex = ds[i]
        assert ex["pool_ranges_4"].shape[1] == 2 and len(ex["pool_ranges_4"]) >= 1
        assert ex["audio"].dtype == np.float32 and len(ex["text_input_ids"]) > 0
