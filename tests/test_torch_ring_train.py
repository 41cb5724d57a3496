"""One KD train step on a seq-2 ring (``use_ring_attention`` and
``encoder_sp`` on ``tiny_test.yaml``, 2 ranks over gloo on the CPU) against
the JAX package's unsharded step from the same weights and batch:

  * ntp, ld, fd, total and ``grad_norm`` within 5e-3·max(1, |a|), the bound
    of tests/test_ring_attention.py for the JAX ring step; the encoder
    gradients are summed over the ranks before the clip, so ``grad_norm`` is
    the norm of the full gradient;
  * the updated encoder parameters within 1e-5, the bound of
    tests/test_torch_train.py (a hundredth of the first AdamW step);
  * both ranks equal: the same losses and, bit for bit, the same update.
With remat the ring's collectives replay in the backward's recompute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ring_worker import run_ranks

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.data import SyntheticSpeechDataset, collate_batch
from llm_speech_summarization_tpu.models import audio_encoder as jae
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.train import make_train_state as jax_make_train_state
from llm_speech_summarization_tpu.train import make_train_step as jax_make_train_step
from llm_speech_summarization_tpu.utils.prompts import prompt_template_for
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
from llm_speech_summarization_tpu_torch.train.trainer import spliced_length

torch.set_num_threads(1)

JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX unsharded step on one batch: (inputs for the ranks, metrics,
    updated params, start params)."""
    jcfg = jax_load_config(JAX_TINY)
    tok = ByteTokenizer()
    tpl = prompt_template_for(jcfg.model.llm_type)
    prefix = tok.encode(tpl.prefix, add_bos=True)
    suffix = tok.encode(tpl.suffix, add_bos=False)
    llm_cfg = jllama.llama_preset("tiny")
    llm_params = jllama.init_llama_params(jax.random.PRNGKey(0), llm_cfg, dtype=jnp.float32)
    setup = jae.encoder_setup_from_config(jcfg)
    enc_params = jae.init_audio_encoder(jax.random.PRNGKey(1), setup, dtype=jnp.float32)
    ds = SyntheticSpeechDataset(tok, num_samples=4, max_seconds=2.0)
    b = jcfg.train.buckets
    batch = collate_batch([ds[i] for i in range(2)], audio_buckets=b.audio_samples,
                          max_text_tokens=b.max_text_tokens,
                          max_response_tokens=b.max_response_tokens)
    assert batch.wav.shape[1] % (320 * 2) == 0  # the encoder shards on 2 ranks
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    total_len = spliced_length(cfg, encoder_setup_from_config(cfg), len(prefix), len(suffix),
                               batch.wav.shape[1])
    jstate, tx = jax_make_train_state(jcfg, enc_params, total_opt_steps=100)
    step = jax_make_train_step(jcfg, setup, llm_cfg, tx, jnp.asarray(prefix), jnp.asarray(suffix),
                               total_len, donate=False)
    new_state, metrics = step(jstate, llm_params, batch)
    inputs = dict(config=str(YAML_DIR / "tiny_test.yaml"),
                  llm_params=bridge.params_from_numpy(np_tree(llm_params)),
                  enc_params=bridge.params_from_numpy(np_tree(enc_params)),
                  batch=bridge.batch_from_numpy(batch), prefix=prefix, suffix=suffix,
                  total_len=total_len)
    return (inputs, {k: float(v) for k, v in metrics.items()},
            jax.tree.flatten(np_tree(new_state.enc_params))[0],
            jax.tree.flatten(np_tree(enc_params))[0])


@pytest.mark.parametrize("remat", [False, True])
def test_ring_kd_step_matches_jax_unsharded(tmp_path, jax_step, remat):
    inputs, want, want_params, start = jax_step
    inputs = dict(inputs, train=dict(use_ring_attention=True, encoder_sp=True, remat=remat))
    torch.save(inputs, tmp_path / "inputs.pt")
    outs = run_ranks("train_step", tmp_path, 2)
    assert outs[0]["metrics"] == outs[1]["metrics"]
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert torch.equal(a, b)
    got = outs[0]["metrics"]
    for key in ("ntp_loss", "ld_loss", "fd_loss", "total_loss", "grad_norm"):
        assert abs(got[key] - want[key]) < 5e-3 * max(1.0, abs(want[key])), (key, got, want)
    assert len(outs[0]["params"]) == len(want_params)
    moved = 0
    for g, w, p0 in zip(outs[0]["params"], want_params, start):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
        moved += int((g.numpy() != p0).sum())
    assert moved > 0.9 * sum(p.size for p in start)
