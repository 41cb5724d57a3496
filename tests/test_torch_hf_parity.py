"""The port's models against HuggingFace's on tiny random models (CPU), as
``tests/test_hf_parity.py`` holds the JAX package's, with its tolerances:
the tiny ``transformers`` models are built from configs (nothing is
downloaded), their state dicts converted by the port's
``models/convert.py``. Llama logits and hidden states (plain and llama3
rope), HuBERT frames (layer- and group-normed stems), HuBERT-CTC logits,
Whisper encoder frames and the log-mel frontend; the convert CLI round trip
into an engine, and the fused and int8 parameter layouts."""

import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.models.convert import (
    convert_hubert,
    convert_hubert_ctc,
    convert_llama,
    convert_whisper_encoder,
)
from llm_speech_summarization_tpu_torch.models.hubert import (
    HubertConfig,
    hubert_ctc_logits,
    hubert_forward,
)
from llm_speech_summarization_tpu_torch.models.llama import (
    LlamaConfig,
    fuse_llama_params,
    init_llama_params,
    llama_forward,
    llama_preset,
    quantize_llama_params,
)
from llm_speech_summarization_tpu_torch.models.whisper import (
    WhisperConfig,
    log_mel_spectrogram,
    whisper_forward,
)
from llm_speech_summarization_tpu_torch.ops.rope import Llama3RopeScaling

transformers = pytest.importorskip("transformers", reason="the HF reference models")

torch.set_num_threads(2)


def _sd(model):
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("use_llama3_rope", [False, True])
def test_llama_logits_match_hf(use_llama3_rope):
    kwargs = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=2048,
                  rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=True,
                  attention_bias=False, mlp_bias=False)
    scaling = None
    if use_llama3_rope:
        kwargs["rope_scaling"] = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                  "high_freq_factor": 4.0,
                                  "original_max_position_embeddings": 512}
        scaling = Llama3RopeScaling(factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                                    original_max_position_embeddings=512)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(**kwargs)).eval()
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
                      rope_scaling=scaling, tie_embeddings=True)
    params = convert_llama(_sd(hf), cfg)

    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 10)).astype(np.int64))
    with torch.no_grad():
        hf_out = hf(input_ids=ids, output_hidden_states=True)
        ours = llama_forward(params, cfg, input_ids=ids, return_hidden=True)
    np.testing.assert_allclose(ours.logits.numpy(), hf_out.logits.numpy(), rtol=2e-4, atol=2e-4)
    # hidden-state layout at the FD layers (the last differs: HF post-norms it)
    for layer in (0, 1):
        np.testing.assert_allclose(ours.hidden_states[layer].numpy(),
                                   hf_out.hidden_states[layer].numpy(), rtol=2e-4, atol=2e-4)


def _hf_hubert_config(variant):
    stable = variant == "layer"
    return transformers.HubertConfig(
        vocab_size=32, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, conv_dim=(32, 32, 32, 32), conv_kernel=(10, 8, 4, 4),
        conv_stride=(5, 4, 4, 4), conv_bias=stable, feat_extract_norm=variant,
        do_stable_layer_norm=stable, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, hidden_dropout=0.0, attention_dropout=0.0,
        feat_proj_dropout=0.0, activation_dropout=0.0, final_dropout=0.0, layerdrop=0.0,
        feat_proj_layer_norm=True)


def _hubert_config(variant):
    stable = variant == "layer"
    return HubertConfig(conv_dims=(32, 32, 32, 32), conv_kernels=(10, 8, 4, 4),
                        conv_strides=(5, 4, 4, 4), conv_bias=stable, feat_extract_norm=variant,
                        hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                        do_stable_layer_norm=stable, pos_conv_kernel=16, pos_conv_groups=4)


@pytest.mark.parametrize("variant", ["layer", "group"])
def test_hubert_frames_match_hf(variant):
    torch.manual_seed(1)
    hf = transformers.HubertModel(_hf_hubert_config(variant)).eval()
    cfg = _hubert_config(variant)
    params = convert_hubert(_sd(hf), cfg)
    wav = torch.from_numpy((0.1 * np.random.RandomState(2).randn(2, 8000)).astype(np.float32))
    with torch.no_grad():
        want = hf(wav).last_hidden_state.numpy()
        ours, _ = hubert_forward(params, cfg, wav)
    np.testing.assert_allclose(ours.numpy(), want, rtol=2e-3, atol=2e-4)


def test_hubert_ctc_matches_hf():
    torch.manual_seed(5)
    hf = transformers.HubertForCTC(_hf_hubert_config("layer")).eval()
    cfg = _hubert_config("layer")
    enc, head = convert_hubert_ctc(_sd(hf), cfg)
    wav = torch.from_numpy((0.1 * np.random.RandomState(6).randn(1, 8000)).astype(np.float32))
    with torch.no_grad():
        want = hf(wav).logits.numpy()
        ours, _ = hubert_ctc_logits(enc, head, cfg, wav)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), want, rtol=2e-3, atol=2e-4)


def test_whisper_encoder_matches_hf():
    hf_cfg = transformers.WhisperConfig(
        vocab_size=128, d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_layers=1, decoder_attention_heads=4, decoder_ffn_dim=128,
        num_mel_bins=80, max_source_positions=1500, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=1)
    torch.manual_seed(3)
    hf = transformers.WhisperModel(hf_cfg).eval().encoder
    cfg = WhisperConfig(d_model=64, num_layers=2, num_heads=4, ffn_dim=128)
    params = convert_whisper_encoder(_sd(hf), cfg)
    mel = torch.from_numpy(np.random.RandomState(4).randn(1, 80, 3000).astype(np.float32) * 0.5)
    with torch.no_grad():
        want = hf(mel).last_hidden_state.numpy()
        ours, _ = whisper_forward(params, cfg, mel)
    np.testing.assert_allclose(ours.numpy(), want, rtol=2e-3, atol=2e-4)


def test_log_mel_matches_whisper_feature_extractor():
    fe = transformers.WhisperFeatureExtractor()  # 80 mels, n_fft 400, hop 160
    wav = (0.1 * np.random.RandomState(5).randn(24000)).astype(np.float32)
    want = fe(wav, sampling_rate=16000, return_tensors="np").input_features[0]
    ours = log_mel_spectrogram(torch.from_numpy(wav[None]), WhisperConfig(),
                               pad_to_frames=3000)[0].numpy()
    assert ours.shape == want.shape
    np.testing.assert_allclose(ours, want, rtol=1e-3, atol=2e-3)


def test_convert_cli_roundtrip(tmp_path):
    """HF dir → cli.convert → an engine loading it through
    ``model.llm_checkpoint`` → logits equal HF's."""
    from llm_speech_summarization_tpu_torch.cli.convert import main as convert_main
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference

    torch.manual_seed(9)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=True, attention_bias=False, mlp_bias=False)).eval()
    hf_dir = tmp_path / "hf"
    hf.save_pretrained(str(hf_dir), safe_serialization=True)
    out = str(tmp_path / "converted.pt")
    convert_main(["llm", "--hf_dir", str(hf_dir), "--preset", "tiny", "--output", out,
                  "--dtype", "float32"])
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    cfg.model.llm_checkpoint = out
    eng = LLMSpeechTextInference(cfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 512, (1, 8)).astype(np.int64))
    with torch.no_grad():
        want = hf(input_ids=ids).logits.numpy()
        ours = llama_forward(eng.llm_params, eng.llm_cfg, input_ids=ids).logits
    np.testing.assert_allclose(ours.numpy(), want, rtol=2e-4, atol=2e-4)


def test_fused_params_identical():
    """``fuse_llama_params`` (the decode layout) gives identical logits."""
    cfg = llama_preset("tiny")
    p = init_llama_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 16)))
    with torch.no_grad():
        ref = llama_forward(p, cfg, input_ids=ids).logits
        got = llama_forward(fuse_llama_params(dict(p)), cfg, input_ids=ids).logits
    assert torch.equal(ref, got)


def test_quantized_params_close_and_same_greedy():
    """Weight-only int8 stays within 5% of the bf16 logits and picks the
    same greedy tokens on a random batch."""
    cfg = llama_preset("tiny")
    p = init_llama_params(torch.Generator().manual_seed(0), cfg, dtype=torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 16)))
    with torch.no_grad():
        ref = llama_forward(p, cfg, input_ids=ids).logits
        got = llama_forward(quantize_llama_params(fuse_llama_params(dict(p))), cfg,
                            input_ids=ids).logits
    rel = float((ref - got).abs().max() / (ref.abs().max() + 1e-9))
    assert rel < 0.05, rel
    assert torch.equal(ref.argmax(-1), got.argmax(-1))
