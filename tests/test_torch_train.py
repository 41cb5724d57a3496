"""The port's training slice against the JAX package's on the CPU: the LLM's
training forward (with and without remat), one KD train step on
``tiny_test.yaml`` from the same weights and batch (float32 and int8 frozen
LLM, and two micro-steps of gradient accumulation), the learning-rate
schedule, checkpoint → resume continuing bit-identically, the Trainer end
to end, and the entry points' device rule.

Tolerances: forward values atol 1e-4 (float32 through two blocks, summed
in another order); losses rtol 1e-5; grad_norm rtol 1e-4; updated encoder
parameters atol 1e-5, a hundredth of the first AdamW step (lr 1e-3: an
update is about lr * sign(g), so a parameter moved the wrong way or by a
wrong lr fails; the slack covers gradients so small that Adam's eps and
float32 summation order decide their update, seen up to 1.8e-6).
"""

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
from llm_speech_summarization_tpu.train.state import lr_at as jax_lr_at
from llm_speech_summarization_tpu.train.state import make_schedule
from llm_speech_summarization_tpu.utils.prompts import prompt_template_for
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.cli import train as cli_train
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.models.audio_encoder import (
    audio_embed_buffer_len,
    audio_encoder_forward,
    encoder_setup_from_config,
    init_audio_encoder,
)
from llm_speech_summarization_tpu_torch.train import checkpoint as ckpt
from llm_speech_summarization_tpu_torch.train import (
    Trainer,
    lr_at,
    make_eval_step,
    make_train_state,
    make_train_step,
)
from llm_speech_summarization_tpu_torch.train.state import tree_leaves

torch.set_num_threads(2)

TINY = str(YAML_DIR / "tiny_test.yaml")
JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_at_matches_jax(warmup):
    cfg, jcfg = load_config(TINY), jax_load_config(JAX_TINY)
    cfg.train.optimizer.warmup_steps = jcfg.train.optimizer.warmup_steps = warmup
    sched = make_schedule(jcfg, total_opt_steps=100)
    for step in (0, 3, 10, 11, 50, 99, 100, 150):
        got = lr_at(cfg, 100, step)
        assert got == jax_lr_at(jcfg, 100, step)
        want = float(sched(min(step, 100)))
        assert abs(got - want) <= 1e-7 + 1e-5 * abs(want)


def _llama_case():
    cfg = jllama.llama_preset("tiny")
    params = jllama.init_llama_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.RandomState(1)
    B, T = 2, 20
    embeds = (0.5 * rng.randn(B, T, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, :7] = False  # left pads
    embeds[1, :7] = 0.0
    g_final = rng.randn(B, 5, cfg.hidden_size).astype(np.float32)
    g_hidden = rng.randn(cfg.num_layers + 1, B, 6, cfg.hidden_size).astype(np.float32)
    return cfg, params, embeds, mask, g_final, g_hidden


@pytest.mark.parametrize("remat", [False, True])
def test_llama_training_forward_matches_jax(remat):
    """Hidden-state stack (window 6), final hidden and logits (window 5),
    and the gradient of a scalar of both w.r.t. the input embeddings."""
    cfg, params, embeds, mask, g_final, g_hidden = _llama_case()
    kw = dict(return_hidden=True, hidden_window=6, logit_window=5, return_final_hidden=True)

    def jfn(e):
        out = jllama.llama_forward(params, cfg, inputs_embeds=e, attn_mask=jnp.asarray(mask),
                                   remat=remat, **kw)
        loss = jnp.vdot(out.final_hidden, g_final) + jnp.vdot(out.hidden_states, g_hidden)
        return loss, out

    (_, want), wgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(embeds))
    e = torch.from_numpy(embeds).requires_grad_()
    out = tllama.llama_forward(bridge.params_from_numpy(np_tree(params)), cfg, inputs_embeds=e,
                               attn_mask=torch.from_numpy(mask), remat=remat, **kw)
    loss = (out.final_hidden * torch.from_numpy(g_final)).sum() + \
        (out.hidden_states * torch.from_numpy(g_hidden)).sum()
    loss.backward()
    for name, got, w in (("hidden_states", out.hidden_states, want.hidden_states),
                         ("final_hidden", out.final_hidden, want.final_hidden),
                         ("logits", out.logits, want.logits)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(wgrad), atol=1e-4, rtol=1e-4)


def test_llama_remat_recompute_is_exact_and_save_qkv_raises():
    cfg, params, embeds, mask, g_final, _ = _llama_case()
    tp = bridge.params_from_numpy(np_tree(params))
    grads = []
    for remat in (False, True):
        e = torch.from_numpy(embeds).requires_grad_()
        out = tllama.llama_forward(tp, cfg, inputs_embeds=e, attn_mask=torch.from_numpy(mask),
                                   compute_logits=False, return_final_hidden=True,
                                   logit_window=5, remat=remat)
        (out.final_hidden * torch.from_numpy(g_final)).sum().backward()
        assert out.logits is None
        grads.append(e.grad)
    assert torch.equal(grads[0], grads[1])
    with pytest.raises(NotImplementedError, match="item 10"):
        tllama.llama_forward(tp, cfg, inputs_embeds=torch.from_numpy(embeds), remat=True,
                             remat_policy="save_qkv")


def test_hubert_remat_gradients_equal():
    cfg = load_config(TINY)
    setup = encoder_setup_from_config(cfg)
    jp = jae.init_audio_encoder(jax.random.PRNGKey(2), jae.encoder_setup_from_config(
        jax_load_config(JAX_TINY)), dtype=jnp.float32)
    wav = torch.from_numpy(0.1 * np.random.RandomState(3).randn(2, 16000).astype(np.float32))
    lens = torch.tensor([16000, 9000], dtype=torch.int32)
    grads = []
    for remat in (False, True):
        state, _ = make_train_state(cfg, bridge.params_from_numpy(np_tree(jp)), 10)
        emb, _ = audio_encoder_forward(state.enc_params, setup, wav, lens, remat=remat)
        emb.square().sum().backward()
        grads.append([p.grad for p in tree_leaves(state.enc_params)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def kd_setup():
    jcfg = jax_load_config(JAX_TINY)
    tok = ByteTokenizer()
    tpl = prompt_template_for(jcfg.model.llm_type)
    prefix = tok.encode(tpl.prefix, add_bos=True)
    suffix = tok.encode(tpl.suffix, add_bos=False)
    llm_cfg = jllama.llama_preset("tiny")
    llm_params = jllama.init_llama_params(jax.random.PRNGKey(0), llm_cfg, dtype=jnp.float32)
    enc_setup = jae.encoder_setup_from_config(jcfg)
    enc_params = jae.init_audio_encoder(jax.random.PRNGKey(1), enc_setup, dtype=jnp.float32)
    ds = SyntheticSpeechDataset(tok, num_samples=8, max_seconds=2.0)
    batches = [collate_batch([ds[i] for i in idx], audio_buckets=jcfg.train.buckets.audio_samples,
                             max_text_tokens=jcfg.train.buckets.max_text_tokens,
                             max_response_tokens=jcfg.train.buckets.max_response_tokens)
               for idx in ((0, 1), (2, 3))]
    M = audio_embed_buffer_len(encoder_setup_from_config(load_config(TINY)),
                               max(b.wav.shape[1] for b in batches))
    R, T = jcfg.train.buckets.max_response_tokens, jcfg.train.buckets.max_text_tokens
    total_len = ((len(prefix) + max(M, T) + len(suffix) + R + 63) // 64) * 64
    return dict(jcfg=jcfg, prefix=prefix, suffix=suffix, llm_cfg=llm_cfg, llm_params=llm_params,
                enc_params=enc_params, batches=batches, total_len=total_len)


@pytest.mark.parametrize("llm,accum", [("float32", 1), ("int8", 1), ("float32", 2)])
def test_kd_train_step_matches_jax(kd_setup, llm, accum):
    """From the same encoder weights, frozen LLM and batches: each step's
    ntp/ld/fd/total losses and grad_norm, then the updated encoder params
    (with accum 2: two micro-steps, one averaged AdamW update)."""
    s = kd_setup
    jcfg = s["jcfg"]
    jcfg.train.grad_accum_interval = accum
    llm_params = s["llm_params"]
    if llm == "int8":
        llm_params = jllama.quantize_llama_params(jax.tree_util.tree_map(jnp.copy, llm_params))
    jstate, tx = jax_make_train_state(jcfg, s["enc_params"], total_opt_steps=100)
    jstep = jax_make_train_step(jcfg, jae.encoder_setup_from_config(jcfg), s["llm_cfg"], tx,
                                jnp.asarray(s["prefix"]), jnp.asarray(s["suffix"]),
                                s["total_len"], donate=False)

    cfg = load_config(TINY)
    cfg.train.grad_accum_interval = accum
    state, opt = make_train_state(cfg, bridge.params_from_numpy(np_tree(s["enc_params"])), 100)
    step = make_train_step(cfg, encoder_setup_from_config(cfg), s["llm_cfg"], opt, s["prefix"],
                           s["suffix"], s["total_len"], device="cpu")
    tparams = bridge.params_from_numpy(np_tree(llm_params))
    for batch in s["batches"][:accum]:
        jstate, want = jstep(jstate, llm_params, batch)
        state, got = step(state, tparams, bridge.batch_from_numpy(batch))
        for k in ("ntp_loss", "ld_loss", "fd_loss", "total_loss"):
            np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-4)
    assert state.step == accum and state.opt_state["count"] == 1
    flat_w, _ = jax.tree.flatten(np_tree(jstate.enc_params))
    flat_g = [p.detach().numpy() for p in tree_leaves(state.enc_params)]
    start = jax.tree.flatten(np_tree(s["enc_params"]))[0]
    assert len(flat_w) == len(flat_g)
    moved = 0
    for g, w, p0 in zip(flat_g, flat_w, start):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
        moved += int((g != p0).sum())
    assert moved > 0.9 * sum(p.size for p in start)


def _tiny_trainer_cfg(tmp_path, **train):
    cfg = load_config(TINY)
    cfg.log.checkpoint_dir = str(tmp_path / "ckpt")
    cfg.log.log_dir = str(tmp_path / "logs")
    cfg.log.num_generate_samples = 0
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


def test_checkpoint_resume_continues_bit_identically(tmp_path):
    """Two steps, checkpoint, a new Trainer resumes and takes two more:
    the same parameters and optimizer state, bit for bit, as four steps in
    one run (the resumed run skips the consumed batches of its epoch)."""
    straight = Trainer(_tiny_trainer_cfg(tmp_path / "a", steps=4), run_name="r", device="cpu")
    straight.train()
    cfg = _tiny_trainer_cfg(tmp_path / "b", steps=2)
    Trainer(cfg, run_name="r", device="cpu").train()
    cfg.train.steps = 4
    resumed = Trainer(cfg, run_name="r", device="cpu")
    assert resumed.step == 2 and resumed._resume_epoch_step == 2
    resumed.train()
    assert resumed.step == 4
    for a, b in zip(tree_leaves(straight.state.enc_params), tree_leaves(resumed.state.enc_params)):
        assert torch.equal(a, b)
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(straight.state.opt_state[key]),
                        tree_leaves(resumed.state.opt_state[key])):
            assert torch.equal(a, b)
    assert resumed.state.opt_state["count"] == straight.state.opt_state["count"] == 4


def test_trainer_end_to_end(tmp_path):
    """Four steps + validate (perplexity, one generation) + checkpoint, then
    a second Trainer resumes from it; eval step and encoder export."""
    cfg = _tiny_trainer_cfg(tmp_path)
    cfg.log.num_generate_samples = 1
    t = Trainer(cfg, run_name="t1", device="cpu")
    t.train()
    assert t.step == 4
    lines = open(os.path.join(cfg.log.log_dir, "t1", "metrics.jsonl")).read()
    for key in ("train/ntp_loss", "train/ld_loss", "train/fd_loss", "learning_rate",
                "validation/audio_perplexity", "audio_response"):
        assert key in lines, key
    latest = ckpt.latest_checkpoint(os.path.join(cfg.log.checkpoint_dir, "t1"))
    assert latest.endswith("step_4")
    t2 = Trainer(cfg, run_name="t1", device="cpu")
    assert t2.step == 4
    for a, b in zip(tree_leaves(t.state.enc_params), tree_leaves(t2.state.enc_params)):
        assert torch.equal(a.detach(), b.detach())
    path = ckpt.export_encoder(str(tmp_path / "enc.pt"), t.state.enc_params)
    for a, b in zip(tree_leaves(t.state.enc_params), tree_leaves(ckpt.load_encoder(path))):
        assert torch.equal(a.detach(), b)
    batch = next(t._batches(t.val_ds, 2, False, 0))
    a_sum, a_tok, t_sum, t_tok = make_eval_step(
        cfg, t.enc_setup, t.llm_cfg, t.prefix_ids, t.suffix_ids, t.total_len(batch.wav.shape[1]),
        device="cpu")(t.state.enc_params, t.llm_params, batch)
    # both sequences score the same response tokens
    assert a_tok.item() == t_tok.item() > 0 and np.isfinite([a_sum.item(), t_sum.item()]).all()


def test_async_checkpoint_roundtrip(tmp_path):
    cfg = load_config(TINY)
    setup = encoder_setup_from_config(cfg)
    params = init_audio_encoder(torch.Generator().manual_seed(0), setup, dtype=torch.float32)
    state, _ = make_train_state(cfg, params, 10)
    base = str(tmp_path / "async")
    ckpt.save_train_checkpoint(base, 1, 0, state, block=False)
    ckpt.save_train_checkpoint(base, 2, 0, state, block=False, epoch_step=3)
    ckpt.finalize_saves()
    latest = ckpt.latest_checkpoint(base)
    assert latest.endswith("step_2")
    restored, step, epoch = ckpt.restore_train_checkpoint(latest, state)
    assert (step, epoch, restored["epoch_step"]) == (2, 0, 3)
    for a, b in zip(tree_leaves(state.enc_params), tree_leaves(restored["enc_params"])):
        assert torch.equal(a.detach(), b.detach()) and b.requires_grad


@pytest.mark.parametrize("field", ["model", "seq"])
def test_parallel_configs_raise(tmp_path, field):
    cfg = _tiny_trainer_cfg(tmp_path)
    setattr(cfg.train.mesh, field, 2)
    with pytest.raises(NotImplementedError, match="item 11"):
        Trainer(cfg, device="cpu")


def test_entry_points_need_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    cfg = _tiny_trainer_cfg(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Trainer(cfg)
    setup = encoder_setup_from_config(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_train_step(cfg, setup, tllama.llama_preset("tiny"), None, [1], [2], 128)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_eval_step(cfg, setup, tllama.llama_preset("tiny"), [1], [2], 128)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli_train.main(["-c", TINY, "--steps", "1"])


def test_cli_trains_on_cpu(tmp_path):
    yaml_path = tmp_path / "tiny.yaml"
    text = open(TINY).read().replace("/tmp/lss_tpu_test", str(tmp_path))
    yaml_path.write_text(text.replace("num_generate_samples: 1", "num_generate_samples: 0"))
    cli_train.main(["-c", str(yaml_path), "-n", "cli", "--steps", "1", "--device", "cpu",
                    "--data_source", "synthetic"])
    assert ckpt.latest_checkpoint(str(tmp_path / "checkpoints" / "cli")).endswith("step_1")
