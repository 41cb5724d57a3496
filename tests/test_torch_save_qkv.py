"""The ``save_qkv`` remat policy of the port's ``llama_forward``: the
attention's forward runs once per layer and step (the backward reads the
q, k, v, output and lse it saved), against twice under "full"; and one KD
step under it is held to the JAX KD step under ``save_qkv`` at
``tests/test_torch_train.py``'s tolerances (losses rtol 1e-5, grad_norm
rtol 1e-4, updated encoder parameters atol 1e-5); on a 2-rank ring it
gives "full"'s outputs and gradients bit for bit. Its gradients equal the
other policies' bit for bit: ``tests/test_torch_train.py::
test_llama_remat_recompute_is_exact_and_save_qkv_raises``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from llm_speech_summarization_tpu_torch.kernels import flash_attention as fa
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.models.audio_encoder import (
    audio_embed_buffer_len,
    encoder_setup_from_config,
)
from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step
from llm_speech_summarization_tpu_torch.train.state import tree_leaves

torch.set_num_threads(2)

JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("policy,fwd_per_layer", [("full", 2), ("save_qkv", 1)])
def test_save_qkv_runs_attention_forward_once(monkeypatch, policy, fwd_per_layer):
    """Forward calls of the attention's log-sum-exp forward (B1 + LSE on
    the card) over one forward and backward, with the backward's dq and
    dk/dv once per layer under either policy."""
    calls = {"fwd": 0, "dq": 0}
    for name, key in (("flash_attention_fwd_lse", "fwd"), ("flash_attention_bwd_dq", "dq")):
        orig = getattr(fa, name)

        def counted(*a, orig=orig, key=key, **kw):
            calls[key] += 1
            return orig(*a, **kw)

        monkeypatch.setattr(fa, name, counted)
    cfg = tllama.llama_preset("tiny")
    params = tllama.init_llama_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    e = (0.5 * torch.randn(2, 20, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
         ).requires_grad_()
    out = tllama.llama_forward(params, cfg, inputs_embeds=e, compute_logits=False,
                               return_final_hidden=True, remat=True, remat_policy=policy)
    assert calls == {"fwd": cfg.num_layers, "dq": 0}
    out.final_hidden.square().sum().backward()
    assert calls == {"fwd": fwd_per_layer * cfg.num_layers, "dq": cfg.num_layers}


def test_unknown_remat_policy_raises():
    cfg = tllama.llama_preset("tiny")
    params = tllama.init_llama_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.llama_forward(params, cfg, inputs_embeds=torch.zeros(1, 4, cfg.hidden_size),
                             remat=True, remat_policy="save_mlp")


@pytest.mark.parametrize("llm", ["float32", "int8"])
def test_kd_train_step_save_qkv_matches_jax(llm):
    jcfg = jax_load_config(JAX_TINY)
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    for c in (jcfg, cfg):
        c.train.remat = True
        c.train.remat_policy = "save_qkv"
    tok = ByteTokenizer()
    tpl = prompt_template_for(jcfg.model.llm_type)
    prefix, suffix = tok.encode(tpl.prefix, add_bos=True), tok.encode(tpl.suffix, add_bos=False)
    llm_cfg = jllama.llama_preset("tiny")
    llm_params = jllama.init_llama_params(jax.random.PRNGKey(0), llm_cfg, dtype=jnp.float32)
    if llm == "int8":
        llm_params = jllama.quantize_llama_params(llm_params)
    jsetup = jae.encoder_setup_from_config(jcfg)
    enc_params = jae.init_audio_encoder(jax.random.PRNGKey(1), jsetup, dtype=jnp.float32)
    ds = SyntheticSpeechDataset(tok, num_samples=4, max_seconds=2.0)
    b = jcfg.train.buckets
    batch = collate_batch([ds[0], ds[1]], audio_buckets=b.audio_samples,
                          max_text_tokens=b.max_text_tokens,
                          max_response_tokens=b.max_response_tokens)
    M = audio_embed_buffer_len(encoder_setup_from_config(cfg), batch.wav.shape[1])
    total_len = ((len(prefix) + max(M, b.max_text_tokens) + len(suffix)
                  + b.max_response_tokens + 63) // 64) * 64

    jstate, tx = jax_make_train_state(jcfg, enc_params, total_opt_steps=100)
    jstep = jax_make_train_step(jcfg, jsetup, llm_cfg, tx, jnp.asarray(prefix),
                                jnp.asarray(suffix), total_len, donate=False)
    jstate, want = jstep(jstate, llm_params, batch)
    state, opt = make_train_state(cfg, bridge.params_from_numpy(np_tree(enc_params)), 100)
    step = make_train_step(cfg, encoder_setup_from_config(cfg), llm_cfg, opt, prefix, suffix,
                           total_len, device="cpu")
    state, got = step(state, bridge.params_from_numpy(np_tree(llm_params)),
                      bridge.batch_from_numpy(batch))
    for k in ("ntp_loss", "ld_loss", "fd_loss", "total_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    flat_w = jax.tree.flatten(np_tree(jstate.enc_params))[0]
    flat_g = [p.detach().numpy() for p in tree_leaves(state.enc_params)]
    assert len(flat_w) == len(flat_g)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_ring_llama_save_qkv_equals_full(tmp_path):
    """On a 2-rank ring (gloo on the CPU) the policy holds the same way:
    the ring attention's autograd Function keeps its inputs and output, so
    "save_qkv" gives "full"'s global outputs and each rank's gradient of
    the input embeddings bit for bit."""
    from torch_ring_worker import run_ranks

    cfg = tllama.llama_preset("tiny")
    params = tllama.init_llama_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    B, T, W = 2, 64, 40
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(1, cfg.vocab_size, size=(B, T)))
    mask = torch.from_numpy(np.arange(T)[None, :] >= np.array([0, 37])[:, None])
    g_final = torch.from_numpy(rng.randn(B, T, cfg.hidden_size).astype(np.float32))
    g_hidden = torch.from_numpy(rng.randn(cfg.num_layers + 1, B, W, cfg.hidden_size)
                                .astype(np.float32))
    outs = {}
    for policy in ("full", "save_qkv"):
        work = tmp_path / policy
        work.mkdir()
        kwargs = dict(return_hidden=True, hidden_window=W, return_final_hidden=True,
                      logit_window=0, remat=True, remat_policy=policy)
        torch.save(dict(params=params, preset="tiny", embeds=params["embed_tokens"][ids.long()],
                        mask=mask, kwargs=kwargs, g_final=g_final, g_hidden=g_hidden),
                   work / "inputs.pt")
        outs[policy] = run_ranks("llama_ring", work, 2)
    for r in range(2):
        for key in ("logits", "hidden", "final", "grad_embeds"):
            assert torch.equal(outs["full"][r][key], outs["save_qkv"][r][key]), (r, key)
