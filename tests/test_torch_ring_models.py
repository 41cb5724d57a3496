"""The sequence-parallel models on 2 ranks (gloo on the CPU, one process per
rank) against the JAX package, from the same weights:

  * ``hubert_forward(sp_group=...)`` (conv halos, the pos-conv halos, the
    bidirectional ring) against the JAX unsharded forward and its SP
    forward on a seq-2 mesh, on valid frames within 5e-4 (the bound of
    tests/test_ring_attention.py), with and without remat;
  * the ring ``llama_forward`` against the JAX unsharded logits within 2e-4
    (the same file's bound), and its global windows (hidden-state stack,
    final hidden states) against the port's unsharded forward within 1e-5,
    and the gradient of the input embeddings, summed over the ranks, within
    1e-6 of its largest element (float32 sums of terms that large).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ring_worker import run_ranks

from llm_speech_summarization_tpu.models import hubert as jhubert
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.parallel.mesh import mesh_from_devices
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.models import llama as tllama

torch.set_num_threads(1)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("remat", [False, True])
def test_hubert_sp_matches_jax(tmp_path, remat):
    cfg = jhubert.hubert_preset("tiny")
    params = jhubert.init_hubert_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    B, N = 2, 20480  # divisible by stride (320) * 2 ranks
    rng = np.random.RandomState(3)
    wav_lens = np.array([N, 13000], np.int32)
    wav_mask = np.arange(N)[None, :] < wav_lens[:, None]
    wav = (0.1 * rng.randn(B, N)).astype(np.float32) * wav_mask
    ref, ref_mask = jax.jit(lambda p, w, m: jhubert.hubert_forward(p, cfg, w, m))(
        params, jnp.asarray(wav), jnp.asarray(wav_mask))
    mesh = mesh_from_devices(data=1, model=1, seq=2, devices=jax.devices()[:2])
    sp, sp_mask = jax.jit(lambda p, w, m: jhubert.hubert_forward(p, cfg, w, m, sp_mesh=mesh,
                                                                 sp_axis="seq"))(
        params, jnp.asarray(wav), jnp.asarray(wav_mask))

    torch.save(dict(params=bridge.params_from_numpy(np_tree(params)), preset="tiny",
                    wav=torch.from_numpy(wav), wav_mask=torch.from_numpy(wav_mask), remat=remat),
               tmp_path / "inputs.pt")
    outs = run_ranks("hubert_sp", tmp_path, 2)
    assert torch.equal(outs[0]["frames"], outs[1]["frames"])  # gathered on every rank
    frames, mask = outs[0]["frames"].numpy(), outs[0]["mask"].numpy()
    assert frames.shape == ref.shape
    np.testing.assert_array_equal(mask, np.asarray(ref_mask))
    np.testing.assert_array_equal(mask, np.asarray(sp_mask))
    for name, want in (("unsharded", ref), ("sp", sp)):
        diff = np.abs(frames - np.asarray(want)) * mask[:, :, None]
        assert diff.max() < 5e-4, (name, diff.max())


def test_llama_ring_matches_jax(tmp_path):
    cfg = jllama.llama_preset("tiny")
    params = jllama.init_llama_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    B, T, W = 2, 64, 40  # the window spans both shards
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    pads = np.array([0, 37])  # a pad that reaches into the second shard
    mask = np.arange(T)[None, :] >= pads[:, None]
    ref = jllama.llama_forward(params, cfg, input_ids=jnp.asarray(ids),
                               attn_mask=jnp.asarray(mask), attn_impl="xla")

    tparams = bridge.params_from_numpy(np_tree(params))
    embeds = tparams["embed_tokens"][torch.from_numpy(ids).long()]
    kwargs = dict(return_hidden=True, hidden_window=W, return_final_hidden=True, logit_window=0)
    g_final = torch.from_numpy(rng.randn(B, T, cfg.hidden_size).astype(np.float32))
    g_hidden = torch.from_numpy(rng.randn(cfg.num_layers + 1, B, W, cfg.hidden_size)
                                .astype(np.float32))
    e = embeds.clone().requires_grad_()
    plain = tllama.llama_forward(tparams, cfg, inputs_embeds=e, attn_mask=torch.from_numpy(mask),
                                 **kwargs)
    ((plain.final_hidden * g_final).sum() + (plain.hidden_states * g_hidden).sum()).backward()

    torch.save(dict(params=tparams, preset="tiny", embeds=embeds, mask=torch.from_numpy(mask),
                    kwargs=kwargs, g_final=g_final, g_hidden=g_hidden), tmp_path / "inputs.pt")
    outs = run_ranks("llama_ring", tmp_path, 2)
    for key in ("logits", "hidden", "final"):  # global outputs, on every rank
        assert torch.equal(outs[0][key], outs[1][key]), key
    valid = mask[:, :, None]
    diff = np.abs(outs[0]["logits"].numpy() - np.asarray(ref.logits)) * valid
    assert diff.max() < 2e-4, diff.max()
    for key, want in (("hidden", plain.hidden_states), ("final", plain.final_hidden)):
        got = outs[0][key].numpy()
        sel = valid if key == "final" else valid[None, :, -W:]
        np.testing.assert_allclose(got * sel, want.detach().numpy() * sel, atol=1e-5, rtol=0,
                                   err_msg=key)
    # each rank's gradient covers its shard's contribution; their sum is the whole
    grad = outs[0]["grad_embeds"] + outs[1]["grad_embeds"]
    scale = e.grad.abs().max().item()  # float32 sums of terms this large: 1e-6 of it
    np.testing.assert_allclose(grad.numpy() * valid, e.grad.numpy() * valid, atol=1e-6 * scale,
                               rtol=0)
