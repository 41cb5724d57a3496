"""The port's ``AudioEncoder`` wrapper (``models/audio_encoder.py``): its
init is ``init_audio_encoder`` on the same generator, its call is
``audio_encoder_forward`` bit for bit, and from bridged JAX parameters it
gives the JAX ``AudioEncoder``'s embeddings within the encoder tests'
tolerance (atol 1e-4 / rtol 1e-3, as ``tests/test_torch_models.py``), for
the pool, stack and ctc_pool projectors."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.models import AudioEncoder as JaxAudioEncoder
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.models import (
    AudioEncoder,
    audio_encoder_forward,
    init_audio_encoder,
)

torch.set_num_threads(1)

JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")


def _configs(method):
    cfgs = (jax_load_config(JAX_TINY), load_config(str(YAML_DIR / "tiny_test.yaml")))
    for c in cfgs:
        c.model.audio_encoder.downsample_method = method
    return cfgs


def _inputs(method):
    rng = np.random.RandomState(5)
    wav = (0.1 * rng.randn(2, 16000)).astype(np.float32)
    lens = np.asarray([16000, 11000], np.int32)
    ranges = None
    if method == "ctc_pool":  # 4-frame ranges, the second row's fewer and padded
        ranges = np.zeros((2, 12, 2), np.int32)
        for b, n in enumerate((12, 8)):
            ranges[b, :n] = [(4 * i, 4 * i + 4) for i in range(n)]
    return wav, lens, ranges


@pytest.mark.parametrize("method", ["pool", "stack", "ctc_pool"])
def test_audio_encoder_wrapper_matches_forward_and_jax(method):
    jcfg, cfg = _configs(method)
    enc = AudioEncoder(cfg, dtype=torch.float32, device="cpu")
    params = enc.init(torch.Generator().manual_seed(3))
    again = init_audio_encoder(torch.Generator().manual_seed(3), enc.setup, torch.float32,
                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params), _leaves(again)))
    wav, lens, ranges = _inputs(method)
    args = (torch.from_numpy(wav), torch.from_numpy(lens),
            None if ranges is None else torch.from_numpy(ranges))
    got, got_lens = enc(params, *args)
    want, want_lens = audio_encoder_forward(params, enc.setup, *args)
    assert torch.equal(got, want) and torch.equal(got_lens, want_lens)

    jenc = JaxAudioEncoder(jcfg, dtype=jnp.float32)
    jp = jenc.init(jax.random.PRNGKey(4))
    jout, jlens = jenc(jp, jnp.asarray(wav), jnp.asarray(lens),
                       None if ranges is None else jnp.asarray(ranges))
    got, got_lens = enc(bridge.encoder_params_from_numpy(jax.tree.map(np.asarray, jp)), *args)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(jlens))
    for b, n in enumerate(np.asarray(jlens)):
        np.testing.assert_allclose(got.numpy()[b, :n], np.asarray(jout)[b, :n], atol=1e-4,
                                   rtol=1e-3)


def test_audio_encoder_wrapper_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AudioEncoder(load_config(str(YAML_DIR / "tiny_test.yaml")))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
