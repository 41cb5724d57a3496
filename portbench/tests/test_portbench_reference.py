"""The plain reference against the port's CPU path at the tiny presets, in
float32: HuBERT frames, Whisper's log-mel and frames, the projector, the
decoder's logits (a prefill, and decode steps over the int8 cache), and
one KD step's loss and encoder gradients."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.core import port_config
from portbench.reference import kd
from portbench.reference import model as ref
from portbench.tests.conftest import REPO, TINY_HUBERT, TINY_WHISPER, tiny_config

SEED = 31337


def _setup(name, encoder, tmp_path):
    cfg_file = tiny_config(name, encoder)
    cfg_file["overrides"].update({"model.param_dtype": "float32", "model.compute_dtype": "float32"})
    cfg = port_config(REPO, cfg_file, str(tmp_path))
    llm = weights.make_llm(cfg_file, SEED, "cpu", torch.float32)
    enc = weights.make_encoder(cfg_file, SEED, "cpu", torch.float32)
    return cfg_file, cfg, llm, enc


def _clips(lens):
    rng = np.random.RandomState(5)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in lens]


@pytest.mark.parametrize("name,encoder", [("tiny_hubert", TINY_HUBERT),
                                          ("tiny_whisper", TINY_WHISPER)])
def test_audio_embeddings(name, encoder, tmp_path):
    from llm_speech_summarization_tpu_torch.models.audio_encoder import (
        audio_encoder_forward, encoder_setup_from_config)

    cfg_file, cfg, _, enc = _setup(name, encoder, tmp_path)
    setup = encoder_setup_from_config(cfg)
    clips = _clips([12000, 23456, 20000])
    N = -(-max(map(len, clips)) // 1600) * 1600
    wav = torch.zeros(len(clips), N)
    for i, c in enumerate(clips):
        wav[i, :len(c)] = torch.from_numpy(c)
    lens = torch.tensor([len(c) for c in clips], dtype=torch.int32)
    got, got_lens = audio_encoder_forward(enc, setup, wav, lens)
    for i, c in enumerate(clips):
        want = ref.audio_embeds(enc, cfg_file, torch.from_numpy(c), N)
        assert int(got_lens[i]) == want.shape[0] > 0
        torch.testing.assert_close(got[i, :want.shape[0]], want, rtol=1e-4, atol=1e-5)


def test_decoder_prefill_and_int8_cache_steps(tmp_path):
    from llm_speech_summarization_tpu_torch.models.llama import init_kv_cache, llama_forward

    cfg_file, cfg, llm, _ = _setup("tiny_hubert", TINY_HUBERT, tmp_path)
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset

    lcfg = llama_preset("tiny")
    g = torch.Generator().manual_seed(3)
    n_p, steps = 9, 5
    x = torch.randn(n_p, 64, generator=g) * 0.5
    toks = torch.randint(0, 512, (steps,), generator=g)
    full = llama_forward(llm, lcfg, inputs_embeds=x[None]).logits[0]
    want, _ = ref.llama(llm, cfg_file["llm"], x)
    torch.testing.assert_close(full, want, rtol=1e-4, atol=1e-4)

    cache = init_kv_cache(lcfg, 1, n_p + steps, dtype=torch.int8)
    out = llama_forward(llm, lcfg, inputs_embeds=x[None], kv_cache=cache, cache_offset=0,
                        last_logit_only=True)
    got = [out.logits[0, -1]]
    for j in range(steps - 1):
        out = llama_forward(llm, lcfg, input_ids=toks[j].view(1, 1), kv_cache=cache,
                            cache_offset=n_p + j, kv_pad_lens=torch.zeros(1, dtype=torch.int32),
                            positions=torch.tensor([[n_p + j]]))
        got.append(out.logits[0, 0])
    seq = torch.cat([x, ref.token_embeds(llm, toks[:-1].tolist())])
    want, _ = ref.llama(llm, cfg_file["llm"], seq, n_prompt=n_p, logits_from=n_p - 1)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)
    # the cache's rounding shows: the exact attention is further off
    exact, _ = ref.llama(llm, cfg_file["llm"], seq, logits_from=n_p - 1)
    assert (exact[1:] - want[1:]).abs().max() > 10 * (torch.stack(got) - want).abs().max()


def test_kd_step_loss_and_gradients(tmp_path):
    from llm_speech_summarization_tpu_torch.data.collate import collate_batch
    from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset
    from llm_speech_summarization_tpu_torch.train.step import _forward_losses
    from llm_speech_summarization_tpu_torch.train.state import make_train_state, tree_leaves

    cfg_file, cfg, llm, enc = _setup("tiny_hubert", TINY_HUBERT, tmp_path)
    rng = np.random.RandomState(7)
    exs = [{"audio": c, "text_input_ids": rng.randint(0, 512, size=n_t).astype(np.int32),
            "response_input_ids": rng.randint(0, 512, size=n_r).astype(np.int32)}
           for c, n_t, n_r in zip(_clips([9000, 20000, 15000]), (5, 9, 7), (12, 3, 20))]
    tr = cfg_file["train"]
    batch = collate_batch(exs, tr["audio_buckets"], tr["max_text_tokens"],
                          tr["max_response_tokens"])
    state, _ = make_train_state(cfg, enc, 10)
    tpl = cfg_file["template"]
    prefix = torch.tensor([tpl["bos_id"]] + list(tpl["prefix"].encode()), dtype=torch.int32)
    suffix = torch.tensor(list(tpl["suffix"].encode()), dtype=torch.int32)
    setup = encoder_setup_from_config(cfg)
    from llm_speech_summarization_tpu_torch.train.trainer import spliced_length

    total_len = spliced_length(cfg, setup, len(prefix), len(suffix), batch.wav.shape[1])
    total, _ = _forward_losses(state.enc_params, llm, batch.to_device("cpu"), enc_setup=setup,
                               llm_cfg=llama_preset("tiny"), cfg=cfg, prefix_ids=prefix,
                               suffix_ids=suffix, total_len=total_len, remat=False)
    leaves = tree_leaves(state.enc_params)
    got_g = torch.autograd.grad(total, leaves)

    ref_batch = [{"wav": torch.from_numpy(e["audio"]), "text_ids": e["text_input_ids"].tolist(),
                  "response_ids": e["response_input_ids"].tolist(),
                  "batch_samples": batch.wav.shape[1]} for e in exs]
    params = {k: v.detach().clone().requires_grad_() for k, v in kd.leaves(enc).items()}
    counts = kd.batch_counts(ref_batch)
    want = sum(kd.utterance_loss(llm, kd.rebuild(enc, params), cfg_file, ex, counts)
               for ex in ref_batch)
    want_g = torch.autograd.grad(want, list(params.values()))
    torch.testing.assert_close(total.detach(), want.detach(), rtol=1e-5, atol=1e-6)
    # each leaf within 2e-3 of its own largest element, or of the largest
    # element of any leaf where its gradient is nought to rounding (the key
    # bias under softmax)
    top = max(float(w.abs().max()) for w in want_g)
    for g, w in zip(got_g, want_g):
        scale = max(float(w.abs().max()), 1e-4 * top)
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3 * scale)
