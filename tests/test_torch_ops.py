"""The PyTorch port's ops against the JAX package's, on the same numpy
inputs made from a seed, in float32 (atol 1e-6 / rtol 1e-5: the same math
in another framework, so only float32 rounding order differs)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.ops import attention as jattn
from llm_speech_summarization_tpu.ops import norms as jnorms
from llm_speech_summarization_tpu.ops import pooling as jpool
from llm_speech_summarization_tpu.ops import rope as jrope
from llm_speech_summarization_tpu.ops import splice as jsplice
from llm_speech_summarization_tpu_torch.ops import attention, norms, pooling, rope, splice

torch.set_num_threads(1)

ATOL, RTOL = 1e-6, 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 64)])
def test_rms_norm(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(shape[-1]).astype(np.float32)
    close(norms.rms_norm(t(x), t(w), 1e-5), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 64)])
def test_layer_norm(shape):
    rng = np.random.RandomState(1)
    x = (3.0 + rng.randn(*shape)).astype(np.float32)
    w, b = rng.randn(2, shape[-1]).astype(np.float32)
    close(norms.layer_norm(t(x), t(w), t(b)),
          jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("head_dim,theta", [(128, 500000.0), (16, 10000.0)])
def test_rope_tables_and_apply(scaled, head_dim, theta):
    sc = (rope.Llama3RopeScaling(), jrope.Llama3RopeScaling()) if scaled else (None, None)
    inv_t = rope.rope_inv_freq(head_dim, theta, sc[0])
    inv_j = jrope.rope_inv_freq(head_dim, theta, sc[1])
    close(inv_t, inv_j)
    rng = np.random.RandomState(2)
    pos = rng.randint(0, 3000, size=(2, 7)).astype(np.int32)
    cos_t, sin_t = rope.rope_cos_sin(t(pos), inv_t)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), inv_j)
    # cos/sin of angles up to ~3000 rad: float32 argument rounding dominates
    close(cos_t, cos_j, atol=2e-4, rtol=0)
    close(sin_t, sin_j, atol=2e-4, rtol=0)
    x = rng.randn(2, 7, 3, head_dim).astype(np.float32)
    close(rope.apply_rope_cached(t(x), t(np.asarray(cos_j)), t(np.asarray(sin_j))),
          jrope.apply_rope_cached(jnp.asarray(x), cos_j, sin_j))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S", [(4, 9), (6, 6)])
def test_make_attention_bias(causal, T, S):
    rng = np.random.RandomState(3)
    B = 3
    qv = rng.rand(B, T) > 0.2
    kv = rng.rand(B, S) > 0.3
    got = attention.make_attention_bias(t(qv), t(kv), causal=causal)
    want = jattn.make_attention_bias(jnp.asarray(qv), jnp.asarray(kv), causal=causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 4), (6, 1)])
def test_dot_product_attention(Hq, Hkv):
    rng = np.random.RandomState(4)
    B, T, S, Dh = 2, 5, 8, 16
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    k = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, S, Hkv, Dh).astype(np.float32)
    kv_valid = np.arange(S)[None, :] >= np.array([[0], [3]])
    q_valid = kv_valid[:, S - T:]
    bias_j = jattn.make_attention_bias(jnp.asarray(q_valid), jnp.asarray(kv_valid), causal=True)
    got = attention.dot_product_attention(t(q), t(k), t(v), t(np.asarray(bias_j)))
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias_j)
    close(got, want)


@pytest.mark.parametrize("N,kernel,stride", [(49, 8, 4), (499, 8, 4), (16, 4, 2)])
def test_avg_pool_time(N, kernel, stride):
    x = np.random.RandomState(5).randn(2, N, 8).astype(np.float32)
    close(pooling.avg_pool_time(t(x), kernel, stride),
          jpool.avg_pool_time(jnp.asarray(x), kernel, stride))


@pytest.mark.parametrize("N", [16, 19])
def test_stack_downsample(N):
    x = np.random.RandomState(6).randn(2, N, 3).astype(np.float32)
    close(pooling.stack_downsample(t(x), 4), jpool.stack_downsample(jnp.asarray(x), 4))


def _splice_inputs(seed, with_response):
    rng = np.random.RandomState(seed)
    V, D, B, M = 50, 8, 3, 6
    table = rng.randn(V, D).astype(np.float32)
    prefix = rng.randint(0, V, size=(4,)).astype(np.int32)
    suffix = rng.randint(0, V, size=(3,)).astype(np.int32)
    mid = rng.randn(B, M, D).astype(np.float32)
    mid_lens = np.array([6, 2, 0], np.int32)
    resp = resp_lens = None
    if with_response:
        resp = rng.randint(0, V, size=(B, 5)).astype(np.int32)
        resp_lens = np.array([5, 1, 3], np.int32)
    return table, prefix, suffix, mid, mid_lens, resp, resp_lens


@pytest.mark.parametrize("with_response", [False, True])
@pytest.mark.parametrize("int8_table", [False, True])
def test_splice_sequences(with_response, int8_table):
    table, prefix, suffix, mid, mid_lens, resp, resp_lens = _splice_inputs(7, with_response)
    scale = None
    if int8_table:
        scale = (0.01 + np.random.RandomState(8).rand(table.shape[0])).astype(np.float32)
        table = np.clip(np.round(table * 40), -127, 127).astype(np.int8)
    conv = lambda a, f: None if a is None else f(a)  # noqa: E731
    args = (table, prefix, suffix, mid, mid_lens, resp, resp_lens)
    got = splice.splice_sequences(*(conv(a, t) for a in args), total_len=24,
                                  table_scale=conv(scale, t))
    want = jsplice.splice_sequences(*(conv(a, jnp.asarray) for a in args), total_len=24,
                                    table_scale=conv(scale, jnp.asarray))
    for name in jsplice.SplicedBatch._fields:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype.is_floating_point:
            close(g, w)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_concat_mid_buffers():
    rng = np.random.RandomState(9)
    a = rng.randn(3, 4, 5).astype(np.float32)
    b = rng.randn(3, 6, 5).astype(np.float32)
    al = np.array([4, 0, 2], np.int32)
    bl = np.array([1, 6, 3], np.int32)
    got, got_len = splice.concat_mid_buffers(t(a), t(al), t(b), t(bl))
    want, want_len = jsplice.concat_mid_buffers(*map(jnp.asarray, (a, al, b, bl)))
    close(got, want)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_splice_layout_golden():
    """The full-size llama3 splice layout golden, through the port."""
    from llm_speech_summarization_tpu_torch.utils.prompts import prompt_template_for
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    with open(os.path.join(GOLDEN_DIR, "splice_layout_llama3.json")) as f:
        g = json.load(f)
    tok = ByteTokenizer()
    tpl = prompt_template_for("meta-llama/Llama-3.2-3B-Instruct")
    mids = g["num_audio_embeds"]
    resp = g["response_ids"]
    R = max(len(r) for r in resp)
    resp_ids = np.zeros((2, R), np.int32)
    for b, r in enumerate(resp):
        resp_ids[b, : len(r)] = r
    s = splice.splice_sequences(
        torch.arange(128256, dtype=torch.float32)[:, None],
        torch.tensor(tok.encode(tpl.prefix, add_bos=True), dtype=torch.int32),
        torch.tensor(tok.encode(tpl.suffix, add_bos=False), dtype=torch.int32),
        -torch.ones((2, max(mids), 1)),
        torch.tensor(mids, dtype=torch.int32),
        t(resp_ids),
        torch.tensor([len(r) for r in resp], dtype=torch.int32),
        total_len=g["total_len"],
    )
    layout = s.embeds[:, :, 0].numpy().astype(np.int64)
    layout[~s.attn_mask.numpy()] = -100
    assert layout.tolist() == g["layout"]
    assert s.labels.numpy().tolist() == g["labels"]
    assert s.loss_mask.numpy().astype(int).tolist() == g["loss_mask"]
    assert s.response_mask.numpy().astype(int).tolist() == g["response_mask"]
    assert s.seq_lens.numpy().tolist() == g["seq_lens"]
