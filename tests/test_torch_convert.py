"""The port's HF checkpoint conversion against the JAX package's on the CPU:
the same tiny random ``transformers`` state dicts, written as float32 and
bfloat16 safetensors (one shard and two) and as ``.bin`` files, read by
each package's ``load_hf_state_dict`` and converted by its ``convert_*``;
every leaf equal bit for bit, dtype included (bfloat16 compared through
its exact float32 values). Llama tied and untied, HuBERT with the layer-
and group-normed stem and both weight-norm spellings, HuBERT-CTC, and the
Whisper encoder under all three key prefixes.

One leaf differs by design: the weight-normed ``pos_conv_w`` of a HuBERT
checkpoint stored in bfloat16 safetensors. The JAX converter reduces
||v|| in bfloat16 numpy arithmetic there (its loader hands it bfloat16
arrays), which misses the norm by up to ~10%; the port takes the norm in
float32, as both packages do for every other input, and that leaf is held
to the float32 computation on the same bfloat16 values (ROADMAP §C).

Also: the reader's refusals (an unknown dtype, a directory without
weights), integer and bool buffers passing through, ``cli/convert.py``'s
three kinds, and the engine and trainer on converted files against the same
trees handed over in memory.
"""

import copy
import dataclasses
import json
import os
import struct

import jax
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.models import convert as jconv
from llm_speech_summarization_tpu.models import hubert as jhub
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.models import whisper as jwh
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.cli import convert as cli_convert
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.models import convert as tconv
from llm_speech_summarization_tpu_torch.models import hubert as thub
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.models import whisper as twh
from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
from llm_speech_summarization_tpu_torch.train import checkpoint as tckpt
from llm_speech_summarization_tpu_torch.train.state import tree_map
from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

transformers = pytest.importorskip("transformers", reason="builds the HF models to convert")
safetensors_torch = pytest.importorskip("safetensors.torch", reason="writes the shards")

torch.set_num_threads(2)

TINY = str(YAML_DIR / "tiny_test.yaml")
HUBERT_KW = dict(conv_dims=(32, 32, 32, 32), conv_kernels=(10, 8, 4, 4), conv_strides=(5, 4, 4, 4),
                 hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                 pos_conv_kernel=16, pos_conv_groups=4)


def hf_llama(tied=True, seed=0):
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tied, attention_bias=False, mlp_bias=False)).eval()


def hf_hubert_config(variant="layer"):
    stable = variant == "layer"
    return transformers.HubertConfig(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, conv_dim=(32, 32, 32, 32), conv_kernel=(10, 8, 4, 4),
        conv_stride=(5, 4, 4, 4), conv_bias=stable, feat_extract_norm=variant,
        do_stable_layer_norm=stable, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, activation_dropout=0.0, final_dropout=0.0, layerdrop=0.0)


def hf_whisper_config():
    return transformers.WhisperConfig(
        vocab_size=128, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=4, decoder_ffn_dim=128,
        num_mel_bins=80, max_source_positions=1500, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1)


def hubert_cfgs(variant):
    stable = variant == "layer"
    kw = dict(HUBERT_KW, conv_bias=stable, feat_extract_norm=variant,
              do_stable_layer_norm=stable)
    return jhub.HubertConfig(**kw), thub.HubertConfig(**kw)


def _state_dict(model):
    return {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}


def _rand_model(name, seed):
    """(state dict, JAX converter call, port converter call) of one case."""
    torch.manual_seed(seed)
    if name.startswith("llama"):
        tied = name == "llama_tied"
        sd = _state_dict(hf_llama(tied, seed))
        jcfg = dataclasses.replace(jllama.llama_preset("tiny"), tie_embeddings=tied)
        tcfg = dataclasses.replace(tllama.llama_preset("tiny"), tie_embeddings=tied)
        return sd, (lambda s, d: jconv.convert_llama(s, jcfg, d)), \
            (lambda s, d: tconv.convert_llama(s, tcfg, d))
    if name.startswith("hubert") and name != "hubert_ctc":
        variant = "group" if "group" in name else "layer"
        sd = _state_dict(transformers.HubertModel(hf_hubert_config(variant)).eval())
        if name.endswith("weight_g"):  # the older weight-norm spelling
            p = "encoder.pos_conv_embed.conv."
            sd[p + "weight_g"] = sd.pop(p + "parametrizations.weight.original0")
            sd[p + "weight_v"] = sd.pop(p + "parametrizations.weight.original1")
        jcfg, tcfg = hubert_cfgs(variant)
        return sd, (lambda s, d: jconv.convert_hubert(s, jcfg, d)), \
            (lambda s, d: tconv.convert_hubert(s, tcfg, d))
    if name == "hubert_ctc":
        sd = _state_dict(transformers.HubertForCTC(hf_hubert_config("layer")).eval())
        jcfg, tcfg = hubert_cfgs("layer")
        return sd, (lambda s, d: jconv.convert_hubert_ctc(s, jcfg, d)), \
            (lambda s, d: tconv.convert_hubert_ctc(s, tcfg, d))
    jcfg = jwh.WhisperConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128)
    tcfg = twh.WhisperConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128)
    if name == "whisper_model.encoder":
        sd = _state_dict(transformers.WhisperForConditionalGeneration(hf_whisper_config()))
    elif name == "whisper_encoder":
        sd = _state_dict(transformers.WhisperModel(hf_whisper_config()))
    else:
        sd = _state_dict(transformers.WhisperModel(hf_whisper_config()).encoder)
    return sd, (lambda s, d: jconv.convert_whisper_encoder(s, jcfg, d)), \
        (lambda s, d: tconv.convert_whisper_encoder(s, tcfg, d))


def write_checkpoint(sd, d, fmt):
    """``fmt``: st_f32_1 / st_bf16_2 (safetensors, one or two shards) or
    bin_f32 / bin_bf16; floating tensors stored in that dtype."""
    os.makedirs(d, exist_ok=True)
    dt = torch.bfloat16 if "bf16" in fmt else torch.float32
    sd = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in sd.items()}
    if fmt.startswith("bin"):
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
        return
    keys = sorted(sd)
    shards = [keys] if fmt.endswith("_1") else [keys[::2], keys[1::2]]
    for i, part in enumerate(shards):
        safetensors_torch.save_file({k: sd[k] for k in part}, os.path.join(
            d, f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np(x):
    """A leaf as numpy, bfloat16 as its exact float32 values; its dtype name."""
    if isinstance(x, torch.Tensor):
        return bridge.tensor_to_numpy(x), str(x.dtype).replace("torch.", "")
    a = np.asarray(x)
    return (a.astype(np.float32) if a.dtype.name == "bfloat16" else a), a.dtype.name


CASES = ("llama_tied", "llama_untied", "hubert_layer", "hubert_group", "hubert_layer_weight_g",
         "hubert_ctc", "whisper_model.encoder", "whisper_encoder", "whisper_bare")
# storage → the dtype converted to (both directions of the cast covered)
FORMATS = {"st_f32_1": "float32", "st_bf16_2": "bfloat16", "bin_f32": "bfloat16",
           "bin_bf16": "float32"}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("case", CASES)
def test_converters_match_jax_bit_for_bit(tmp_path, case, fmt):
    sd, jconvert, tconvert = _rand_model(case, seed=CASES.index(case))
    write_checkpoint(sd, tmp_path, fmt)
    dtype = FORMATS[fmt]
    want = _leaves(jax.tree.map(np.asarray, jconvert(jconv.load_hf_state_dict(str(tmp_path)),
                                                     getattr(jax.numpy, dtype))))
    loaded = tconv.load_hf_state_dict(str(tmp_path))
    stored = torch.bfloat16 if "bf16" in fmt else torch.float32
    assert {v.dtype for v in loaded.values() if v.is_floating_point()} == {stored}
    got = _leaves(tconvert(loaded, getattr(torch, dtype)))
    assert set(got) == set(want)
    for key in want:
        (g, g_dt), (w, w_dt) = _np(got[key]), _np(want[key])
        assert g_dt == w_dt == dtype, key
        assert g.shape == w.shape, key
        if key.endswith("pos_conv_w") and fmt == "st_bf16_2":
            # the JAX converter's bfloat16 norm (module docstring); the
            # port's is the float32 one on the same stored values
            p = "hubert." if case == "hubert_ctc" else ""
            names = (("weight_g", "weight_v") if case.endswith("weight_g") else
                     ("parametrizations.weight.original0", "parametrizations.weight.original1"))
            gv = [loaded[f"{p}encoder.pos_conv_embed.conv.{n}"].float().numpy() for n in names]
            norm = np.sqrt(np.sum(gv[1] * gv[1], axis=(0, 1), keepdims=True))
            ref = torch.from_numpy(gv[0] * gv[1] / np.maximum(norm, 1e-12)).to(torch.bfloat16)
            np.testing.assert_array_equal(g, ref.float().numpy(), err_msg=key)
            assert np.abs(g - w).max() > 0  # the JAX leaf is off (its bf16 sums)
            continue
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_reader_dtypes_and_refusals(tmp_path):
    """bf16 arrives as torch.bfloat16 from the map, int64 and bool buffers
    unchanged (also through .bin), an unknown dtype raises, and so does a
    directory without weights."""
    sd = {"a": torch.randn(3, 5).to(torch.bfloat16), "b": torch.arange(7, dtype=torch.int64),
          "c": torch.tensor([True, False, True]), "d": torch.randn(4).half(),
          "e": torch.randn(2, 2), "z": torch.zeros(0, 3)}
    safetensors_torch.save_file(sd, str(tmp_path / "m.safetensors"))
    got = tconv.load_hf_state_dict(str(tmp_path))
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    want = jconv.load_hf_state_dict(str(tmp_path))
    np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    np.testing.assert_array_equal(got["c"].numpy(), want["c"])
    (tmp_path / "bin").mkdir()
    torch.save({"b": sd["b"], "c": sd["c"], "a": sd["a"]}, str(tmp_path / "bin" / "w.bin"))
    got = tconv.load_hf_state_dict(str(tmp_path / "bin"))
    assert got["a"].dtype == torch.bfloat16 and torch.equal(got["b"], sd["b"])
    assert got["c"].dtype == torch.bool and torch.equal(got["c"], sd["c"])

    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}).encode()
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "m.safetensors").write_bytes(
        struct.pack("<Q", len(header)) + header + b"\0\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        tconv.load_hf_state_dict(str(tmp_path / "bad"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tconv.load_hf_state_dict(str(tmp_path / "empty"))


def test_cast_takes_bfloat16_leaves():
    """The requested dtype reaches every floating leaf, bfloat16 ones too;
    integer leaves stay."""
    tree = {"w": torch.ones(2, dtype=torch.bfloat16), "i": torch.ones(2, dtype=torch.int64),
            "l": [torch.ones(1, dtype=torch.float16)]}
    out = tconv._cast(tree, torch.float32)
    assert out["w"].dtype == out["l"][0].dtype == torch.float32
    assert out["i"].dtype == torch.int64


def _write_yaml(tmp_path, **model):
    text = open(TINY).read()
    lines = [f"  {k}: {v}" for k, v in model.items()]
    text = text.replace("  llm_preset: tiny\n", "  llm_preset: tiny\n" + "\n".join(lines) + "\n")
    p = tmp_path / "cfg.yaml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("kind", ["llm", "encoder_hubert", "encoder_whisper", "ctc"])
def test_convert_cli_kinds(tmp_path, kind):
    """Each kind writes one file of the port's format: the converted tree
    (the encoder's backbone inside a full encoder tree whose projector has
    the JAX tree's shapes and dtypes), loadable by ``load_params``."""
    from llm_speech_summarization_tpu.configs import load_config as jload
    from llm_speech_summarization_tpu.models import audio_encoder as jae

    hf = tmp_path / "hf"
    out = str(tmp_path / "out.pt")
    if kind == "llm":
        sd = _state_dict(hf_llama())
        write_checkpoint(sd, hf, "st_bf16_2")
        cli_convert.main(["llm", "--hf_dir", str(hf), "--preset", "tiny", "--output", out])
        got = tckpt.load_params(out)["llm_params"]
        want = tconv.convert_llama(tconv.load_hf_state_dict(str(hf)),
                                   tllama.llama_preset("tiny"), torch.bfloat16)
    elif kind == "ctc":
        sd = _state_dict(transformers.HubertForCTC(hf_hubert_config("layer")))
        write_checkpoint(sd, hf, "st_f32_1")
        cli_convert.main(["ctc", "--hf_dir", str(hf), "--preset", "tiny", "--output", out,
                          "--dtype", "float32"])
        got = tckpt.load_params(out)
        want = dict(zip(("enc_params", "head_params"), tconv.convert_hubert_ctc(
            tconv.load_hf_state_dict(str(hf)), thub.hubert_preset("tiny"), torch.float32)))
    else:
        whisper = kind.endswith("whisper")
        yaml = str(YAML_DIR / "tiny_test.yaml")
        if whisper:
            yaml = str(tmp_path / "w.yaml")
            open(yaml, "w").write(open(TINY).read().replace("base: hubert", "base: whisper"))
        model = (transformers.WhisperModel(hf_whisper_config()) if whisper
                 else transformers.HubertModel(hf_hubert_config("layer")))
        write_checkpoint(_state_dict(model), hf, "bin_f32")
        cli_convert.main(["encoder", "-c", yaml, "--hf_dir", str(hf), "--output", out])
        got = tckpt.load_encoder(out)
        setup = encoder_setup_from_config(load_config(yaml))
        conv = tconv.convert_whisper_encoder if whisper else tconv.convert_hubert
        want_backbone = conv(tconv.load_hf_state_dict(str(hf)), setup.encoder_cfg, torch.bfloat16)
        jtree = jae.init_audio_encoder(jax.random.PRNGKey(0),
                                       jae.encoder_setup_from_config(jload(yaml)),
                                       jax.numpy.bfloat16)
        for k in ("proj_w", "proj_b"):
            assert tuple(got[k].shape) == jtree[k].shape and got[k].dtype == torch.bfloat16
        got, want = got["encoder"], want_backbone
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_engine_loads_converted_files(tmp_path):
    """``model.llm_checkpoint`` and ``model.encoder_checkpoint`` (and the
    ``audio_encoder_checkpoint`` argument, which wins over the config) load
    into an int8 engine, which fuses and quantizes the LLM it loaded: its
    token rows equal those of an engine handed the same trees in memory."""
    hf = tmp_path / "hf"
    write_checkpoint(_state_dict(hf_llama(seed=3)), hf, "st_f32_1")
    llm_file = cli_convert.main(["llm", "--hf_dir", str(hf), "--preset", "tiny", "--output",
                                 str(tmp_path / "llm.pt"), "--dtype", "float32"])
    cfg = load_config(TINY)
    cfg.model.llm_weight_dtype = "int8"
    base = LLMSpeechTextInference(cfg, device="cpu")
    enc_a = tckpt.export_encoder(str(tmp_path / "enc_a.pt"), base.audio_encoder_params)
    enc_b = tckpt.export_encoder(str(tmp_path / "enc_b.pt"), tree_map(
        lambda t: t * 1.5, base.audio_encoder_params))
    cfg.model.llm_checkpoint = llm_file
    cfg.model.encoder_checkpoint = enc_a
    rng = np.random.RandomState(0)
    clips = [(0.1 * rng.randn(n)).astype(np.float32) for n in (9000, 16000, 12000)]
    llm = tckpt.load_params(llm_file)["llm_params"]
    mem_llm = tllama.quantize_llama_params(tllama.fuse_llama_params(llm))
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.model.llm_checkpoint = plain_cfg.model.encoder_checkpoint = None
    for arg, enc_file in ((None, enc_a), (enc_b, enc_b)):
        loaded = LLMSpeechTextInference(cfg, device="cpu", audio_encoder_checkpoint=arg)
        assert loaded.llm_params["layers"]["wqkv"].dtype == torch.int8
        mem = LLMSpeechTextInference(plain_cfg, device="cpu", llm_params=mem_llm,
                                     audio_encoder_params=tckpt.load_encoder(enc_file))
        rows = []
        for eng in (loaded, mem):
            rec, orig = [], ByteTokenizer.decode
            ByteTokenizer.decode = lambda self, ids, *a, rec=rec, **k: rec.append(list(ids)) or \
                orig(self, ids, *a, **k)
            try:
                texts = eng.generate_audio_response_batch(clips, max_new_tokens=8)
                texts += eng.generate_text_response_batch(["hello there"], max_new_tokens=8)
            finally:
                ByteTokenizer.decode = orig
            rows.append((rec, texts))
        assert rows[0] == rows[1] and len(rows[0][0]) == 5  # 3 clips padded to 4, 1 text


def test_trainer_loads_llm_checkpoint_and_refuses_encoder_checkpoint(tmp_path):
    """The trainer loads ``model.llm_checkpoint`` (then int8-quantizes it)
    and still raises for ``model.encoder_checkpoint``, which the JAX
    trainer never reads."""
    from llm_speech_summarization_tpu_torch.train.trainer import Trainer

    hf = tmp_path / "hf"
    write_checkpoint(_state_dict(hf_llama(seed=4)), hf, "st_f32_1")
    llm_file = cli_convert.main(["llm", "--hf_dir", str(hf), "--preset", "tiny", "--output",
                                 str(tmp_path / "llm.pt"), "--dtype", "float32"])
    cfg = load_config(TINY)
    cfg.log.checkpoint_dir, cfg.log.log_dir = str(tmp_path / "c"), str(tmp_path / "l")
    cfg.model.llm_checkpoint = llm_file
    cfg.model.llm_weight_dtype = "int8"
    t = Trainer(cfg, device="cpu")
    want = tllama.quantize_llama_params(tckpt.load_params(llm_file)["llm_params"])
    g, w = _leaves(t.llm_params), _leaves(want)
    assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
    cfg.model.encoder_checkpoint = str(tmp_path / "enc.pt")
    with pytest.raises(ValueError, match="never reads"):
        Trainer(cfg, device="cpu")


def test_serve_cli_passes_the_encoder_checkpoint(tmp_path, monkeypatch):
    """``cli/serve.py -p`` hands the file to the engine through ``serve()``
    (the old refusal is gone), and an engine built that way holds the
    exported tree."""
    from llm_speech_summarization_tpu_torch.cli import serve as cli
    from llm_speech_summarization_tpu_torch.serve import server as server_mod

    eng = LLMSpeechTextInference(load_config(TINY), device="cpu")
    path = tckpt.export_encoder(str(tmp_path / "enc.pt"), tree_map(
        lambda t: t + 1.0, eng.audio_encoder_params))
    seen = {}
    monkeypatch.setattr(server_mod, "serve", lambda config, **kw: seen.update(kw))
    cli.main(["-c", TINY, "-p", path, "--device", "cpu"])
    assert seen["audio_encoder_checkpoint"] == path and seen["device"] == "cpu"
    served = LLMSpeechTextInference(load_config(TINY), device="cpu",
                                    audio_encoder_checkpoint=seen["audio_encoder_checkpoint"])
    g, w = _leaves(served.audio_encoder_params), _leaves(tckpt.load_encoder(path))
    assert set(g) == set(w) and all(torch.equal(g[k], w[k]) for k in w)
