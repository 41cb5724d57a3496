"""Data-, tensor- and 3-D-parallel KD training steps of the port on gloo CPU
ranks, against the JAX package's step on the same mesh shape (on the
virtual CPU devices of tests/conftest.py), at ``tiny_test.yaml`` size:

  * data 2 (mirror of tests/test_parallel.py:78 and :137): the step on two
    ranks, each with half of the global batch, with the replicated
    optimizer and with ZeRO-1, against the JAX step over a data axis of 2
    with its ZeRO-1 state; ZeRO-1's parameters and moments bit-equal to
    the replicated optimizer's;
  * a 3-row tail padded to 4 rows over data 2 (tests/test_round3_fixes.py:81,
    :95) against the JAX step on the 3 rows;
  * model 2: the sharded LLM (no remat, "full", "save_qkv") against the
    JAX step with its LLM sharded over a model axis of 2;
  * the vocab-parallel fused NTP + LD loss (float and int8 heads, each
    rank half the vocab) and its gradient against the JAX fused loss on
    the whole vocab;
  * (data, seq, model) = (2, 2, 2) on eight ranks with the ring, encoder SP
    and ZeRO-1, against the JAX step on the same mesh: the torch
    counterpart of ``__graft_entry__.dryrun_multichip``.

Bounds: losses and ``grad_norm`` within 1e-5·max(1, |a|) and updated
encoder parameters within atol 1e-5 (a hundredth of the first AdamW step,
the bound of tests/test_torch_train.py), every rank of a step equal to the
others bit for bit. A parameter whose JAX move is under a fifth of the
learning rate has a reduced gradient under a quarter of Adam's eps,
float32 noise whose summation order sets the move (JAX's own sharded and
unsharded steps part by up to 3.6e-6 on such a leaf): it is held to
within its move's size, and fewer than 1% of the elements may need that.
The fused loss: values within 1e-5, its gradient within 1e-6 (its
entries are ~1e-3).
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
from llm_speech_summarization_tpu.ops.losses import fused_ntp_ld_losses as jax_fused
from llm_speech_summarization_tpu.parallel import (
    encoder_param_spec,
    llama_param_spec,
    mesh_from_devices,
    shard_batch,
    shard_params,
)
from llm_speech_summarization_tpu.parallel.sharding import opt_state_spec as jax_opt_state_spec
from llm_speech_summarization_tpu.train import make_train_state as jax_make_train_state
from llm_speech_summarization_tpu.train import make_train_step as jax_make_train_step
from llm_speech_summarization_tpu.utils.prompts import prompt_template_for
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.data.batch import Batch
from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
from llm_speech_summarization_tpu_torch.parallel.sharding import (
    ZERO_MIN_SIZE,
    opt_state_spec,
    pad_batch_rows,
    zero_shards,
    zero_slice,
)
from llm_speech_summarization_tpu_torch.parallel.sharding import shard_batch as torch_shard_batch
from llm_speech_summarization_tpu_torch.train.trainer import spliced_length

torch.set_num_threads(1)

JAX_TINY = os.path.join(os.path.dirname(__file__), "..", "llm_speech_summarization_tpu",
                        "configs", "yaml", "tiny_test.yaml")
WORKER = os.path.join(os.path.dirname(__file__), "torch_parallel_worker.py")
ATOL = 1e-5
LR = 1e-3  # tiny_test.yaml's learning rate: the size of a first AdamW move

def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(jcfg, setup, llm_cfg, llm_params, enc_params, prefix, suffix, total_len, batch,
              mesh=None, ring=False):
    """The JAX step on ``mesh`` (None: unsharded), the JAX trainer's
    placements: LLM over "model", optimizer state ZeRO-1 over "data", the
    batch over "data"."""
    p, s = jnp.asarray(prefix), jnp.asarray(suffix)
    if mesh is None:
        state, tx = jax_make_train_state(jcfg, enc_params, total_opt_steps=100)
        step = jax_make_train_step(jcfg, setup, llm_cfg, tx, p, s, total_len, donate=False)
        new, metrics = step(state, llm_params, batch)
    else:
        with mesh:
            llm = shard_params(mesh, llm_params, llama_param_spec(llm_params))
            enc = shard_params(mesh, enc_params, encoder_param_spec(enc_params))
            state, tx = jax_make_train_state(jcfg, enc, total_opt_steps=100)
            if dict(mesh.shape)["data"] > 1:
                state = state._replace(opt_state=shard_params(
                    mesh, state.opt_state, jax_opt_state_spec(state.opt_state, mesh)))
            kw = {"ring_mesh": mesh, "ring_axis": "seq"} if ring else {}
            step = jax_make_train_step(jcfg, setup, llm_cfg, tx, p, s, total_len, donate=False,
                                       **kw)
            new, metrics = step(state, llm, shard_batch(mesh, batch))
    adam = [s for s in jax.tree_util.tree_leaves(new.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")]
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.flatten(np_tree(new.enc_params))[0], np_tree(adam[0].mu))


@pytest.fixture(scope="module")
def setup():
    """Weights, the global batch (4 rows) and its 3-row tail, the ranks'
    inputs, and the JAX steps they are held to."""
    jcfg = jax_load_config(JAX_TINY)
    tok = ByteTokenizer()
    tpl = prompt_template_for(jcfg.model.llm_type)
    prefix = tok.encode(tpl.prefix, add_bos=True)
    suffix = tok.encode(tpl.suffix, add_bos=False)
    llm_cfg = jllama.llama_preset("tiny")
    llm_params = jllama.init_llama_params(jax.random.PRNGKey(0), llm_cfg, dtype=jnp.float32)
    jsetup = jae.encoder_setup_from_config(jcfg)
    enc_params = jae.init_audio_encoder(jax.random.PRNGKey(1), jsetup, dtype=jnp.float32)
    ds = SyntheticSpeechDataset(tok, num_samples=4, max_seconds=1.5)
    b = jcfg.train.buckets

    def collate(rows):
        return collate_batch([ds[i] for i in rows], audio_buckets=b.audio_samples,
                             max_text_tokens=b.max_text_tokens,
                             max_response_tokens=b.max_response_tokens)

    batch, tail = collate(range(4)), collate(range(3))
    assert batch.wav.shape[1] % (320 * 2) == 0  # the encoder shards over seq 2
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    total_len = spliced_length(cfg, encoder_setup_from_config(cfg), len(prefix), len(suffix),
                               batch.wav.shape[1])
    assert tail.wav.shape[1] == batch.wav.shape[1]
    args = (jcfg, jsetup, llm_cfg, llm_params, enc_params, prefix, suffix, total_len)
    devices = jax.devices()
    want = {"dp": _jax_step(*args, batch, mesh_from_devices(data=2, model=1,
                                                            devices=devices[:2])),
            "tp": _jax_step(*args, batch, mesh_from_devices(data=1, model=2,
                                                            devices=devices[:2])),
            "tail": _jax_step(*args, tail)}
    inputs = dict(config=str(YAML_DIR / "tiny_test.yaml"),
                  llm_params=bridge.params_from_numpy(np_tree(llm_params)),
                  enc_params=bridge.params_from_numpy(np_tree(enc_params)),
                  batch=bridge.batch_from_numpy(batch), tail=bridge.batch_from_numpy(tail),
                  prefix=prefix, suffix=suffix, total_len=total_len)
    return dict(args=args, batch=batch, want=want, inputs=inputs,
                start=jax.tree.flatten(np_tree(enc_params))[0])


def _fused_case():
    """The fused loss's inputs (N = 2 x 6 rows, D = 64, V = 512, chunks of
    96 so that each rank's 256 rows end on a part chunk) and the JAX values
    and gradient on the whole vocab."""
    rng = np.random.RandomState(3)
    B, W, D, V = 2, 6, 64, 512
    sh = rng.randn(B, W, D).astype(np.float32)
    th = rng.randn(B, W, D).astype(np.float32)
    labels = rng.randint(0, V, (B, W)).astype(np.int32)
    loss_mask = rng.rand(B, W) > 0.3
    loss_mask[1] = False  # a row with no loss window
    response_mask = rng.rand(B, W) > 0.2
    heads = {"float": (rng.randn(V, D).astype(np.float32) * 0.5, None),
             "int8": (rng.randint(-127, 128, (V, D)).astype(np.int8),
                      (rng.rand(V).astype(np.float32) + 0.5) * 4e-3)}
    w_ntp, w_ld = 0.5, 0.5
    want = {}
    for name, (head, scale) in heads.items():
        def loss(s, head=head, scale=scale):
            ntp, ld = jax_fused(s, jnp.asarray(th), jnp.asarray(head), jnp.asarray(labels),
                                jnp.asarray(loss_mask), jnp.asarray(response_mask),
                                vocab_chunk=96,
                                head_scale=None if scale is None else jnp.asarray(scale))
            return w_ntp * ntp + w_ld * ld, (ntp, ld)

        (_, (ntp, ld)), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(sh))
        want[name] = {"ntp": float(ntp), "ld": float(ld), "grad": np.asarray(grad)}
    t = torch.from_numpy
    inputs = {"sh": t(sh), "th": t(th), "labels": t(labels), "loss_mask": t(loss_mask),
              "response_mask": t(response_mask), "vocab_chunk": 96, "w_ntp": w_ntp, "w_ld": w_ld,
              "heads": {k: (t(h), None if s is None else t(s)) for k, (h, s) in heads.items()}}
    return inputs, want


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    """Both ranks' outputs of the ``steps`` case (one launch) and the
    fused loss's JAX values."""
    d = tmp_path_factory.mktemp("parallel_steps")
    fused_inputs, fused_want = _fused_case()
    torch.save(dict(setup["inputs"], **fused_inputs), d / "inputs.pt")
    return run_ranks("steps", d, 2, timeout=150, script=WORKER), fused_want


def _close(got, want, what):
    for k in ("ntp_loss", "ld_loss", "fd_loss", "total_loss", "grad_norm"):
        assert abs(got[k] - want[k]) <= ATOL * max(1.0, abs(want[k])), (what, k, got, want)


def _held(outs, want, start, what):
    """Every rank equal to rank 0 bit for bit; rank 0 within the bounds of
    the JAX step's metrics and updated parameters."""
    metrics, params, _ = want
    for out in outs[1:]:
        assert out["metrics"] == outs[0]["metrics"], what
        for a, b in zip(out["params"], outs[0]["params"]):
            assert torch.equal(a, b), what
    _close(outs[0]["metrics"], metrics, what)
    assert len(outs[0]["params"]) == len(params)
    moved = eps_ruled = 0
    for g, w, p0 in zip(outs[0]["params"], params, start):
        g = g.numpy()
        # AdamW's first move is lr·g/(|g| + eps): below a fifth of lr the
        # reduced gradient is under eps/4, float32 summation noise, and its
        # order sets the move's size (a 1e-9 gradient moved 7.8e-5 here and
        # 9.5e-5 in JAX): there the move is held to within its own size
        tiny = np.abs(w - p0) < LR / 5
        bound = np.where(tiny, np.maximum(ATOL, np.abs(w - p0)), ATOL)
        assert (np.abs(g - w) <= bound).all(), (what, np.abs(g - w).max())
        eps_ruled += int((tiny & (np.abs(g - w) > ATOL)).sum())
        moved += int((g != p0).sum())
    n = sum(p.size for p in start)
    assert moved > 0.9 * n and eps_ruled < 0.01 * n, (what, moved, eps_ruled, n)


@pytest.mark.parametrize("case", ["dp", "zero"])
def test_data_parallel_step_matches_jax(setup, two_ranks, case):
    outs, _ = two_ranks
    _held([o[case] for o in outs], setup["want"]["dp"], setup["start"], case)


def test_zero1_is_bit_equal_to_the_replicated_optimizer(setup, two_ranks):
    """ZeRO-1 holds half of each large moment leaf per rank, and its step
    equals the replicated optimizer's bit for bit, with and without
    gradient accumulation: the parameters, and the moments gathered
    whole. Each rank's first moments are the slices of the JAX ZeRO-1
    step's (0.1 of the reduced gradient: within 1e-8)."""
    outs, _ = two_ranks
    jax_mu = setup["want"]["dp"][2]
    for r, out in enumerate(outs):
        # two micro-steps of accumulation: the accumulator sliced, gathered
        # whole for the clip and the update
        for a, b in zip(out["zero_accum"]["params"], out["dp_accum"]["params"]):
            assert torch.equal(a, b)
        for a, b in zip(out["zero_accum"]["whole_mu"], out["dp_accum"]["mu"]):
            assert torch.equal(a, b)
        want = jax.tree.flatten(bridge.zero_slices_from_numpy(jax_mu, r, 2))[0]
        for got, w in zip(out["zero"]["mu"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got.numpy(), w.numpy(), atol=1e-8, rtol=0)
        dp, zero = out["dp"], out["zero"]
        for a, b in zip(zero["params"], dp["params"]):
            assert torch.equal(a, b)
        for a, b in zip(zero["whole_mu"], dp["mu"]):
            assert torch.equal(a, b)
        sliced = 0
        for m, whole, n in zip(zero["mu"], dp["mu"], zero["numel"]):
            if zero_shards(whole, 2):
                assert m.numel() * 2 == n and torch.equal(m, zero_slice(whole, r, 2))
                sliced += 1
            else:
                assert m.shape == whole.shape
        assert sliced == 3


def test_padded_tail_step_matches_the_unpadded_rows(setup, two_ranks):
    """Three rows over two data ranks: rank 1 takes row 2 and a copy of row
    0 with no response, which adds no loss, token or gradient."""
    outs, _ = two_ranks
    _held([o["tail"] for o in outs], setup["want"]["tail"], setup["start"], "tail")


@pytest.mark.parametrize("case", ["tp", "tp_full", "tp_save_qkv"])
def test_tensor_parallel_step_matches_jax(setup, two_ranks, case):
    """The LLM sharded over a model group of 2 (each rank 2 of 4 query heads,
    1 of 2 KV heads, half the MLP and the vocab); with remat each block's
    all-reduces replay in the backward's recompute."""
    outs, _ = two_ranks
    _held([o[case] for o in outs], setup["want"]["tp"], setup["start"], case)


def test_model_group_steps_need_the_whole_embedding_table(two_ranks):
    """A shard holds half the vocab rows: its train and eval steps refuse to
    splice without the whole table."""
    outs, _ = two_ranks
    for out in outs:
        assert len(out["no_table"]) == 2
        assert all("pass embed_table" in e for e in out["no_table"])


@pytest.mark.parametrize("head", ["float", "int8"])
def test_vocab_parallel_fused_loss_matches_jax(two_ranks, head):
    outs, want = two_ranks
    w = want[head]
    for out in outs:
        got = out["fused"][head]
        assert abs(got["ntp"] - w["ntp"]) <= ATOL and abs(got["ld"] - w["ld"]) <= ATOL
        np.testing.assert_allclose(got["grad"].numpy(), w["grad"], atol=1e-6, rtol=0)
        assert torch.equal(got["grad"], outs[0]["fused"][head]["grad"])


def test_3d_mesh_step_matches_jax(setup, tmp_path):
    """(data, seq, model) = (2, 2, 2) on eight ranks: each data rank's two
    rows ring over its seq pair, each seq rank's LLM sharded over its model
    pair, the optimizer ZeRO-1 over the data pair; the JAX step on the
    same mesh."""
    args, batch = setup["args"], setup["batch"]
    jcfg = args[0]
    jcfg.train.use_ring_attention = jcfg.train.encoder_sp = True
    try:
        want = _jax_step(*args, batch, mesh_from_devices(data=2, model=2, seq=2,
                                                         devices=jax.devices()[:8]), ring=True)
    finally:
        jcfg.train.use_ring_attention = jcfg.train.encoder_sp = False
    torch.save(setup["inputs"], tmp_path / "inputs.pt")
    outs = run_ranks("steps3d", tmp_path, 8, timeout=150, script=WORKER)
    coords = [o["coords"] for o in outs]
    assert coords == [(d, s, m) for d in range(2) for s in range(2) for m in range(2)]
    for r, out in enumerate(outs):
        assert out["groups"] == {"data": [r % 4, r % 4 + 4], "seq": [r - r % 4 + r % 2,
                                                                     r - r % 4 + r % 2 + 2],
                                 "model": [r - r % 2, r - r % 2 + 1]}
    _held(outs, want, setup["start"], "3d")


def test_sharding_rules():
    """The ZeRO-1 rule (the JAX ``opt_state_spec``: a leading dim that the
    data axis divides and at least 16384 elements), a leaf's slice, and a
    batch's padding and shards."""
    big = torch.zeros(64, 256)
    assert big.numel() == ZERO_MIN_SIZE
    tree = {"a": big, "b": [torch.zeros(63, 512), torch.zeros(8, 8)], "c": torch.zeros(())}
    assert opt_state_spec(tree, 2) == {"a": True, "b": [False, False], "c": False}
    assert opt_state_spec(tree, 1) == {"a": False, "b": [False, False], "c": False}
    assert opt_state_spec(tree, 3) == {"a": False, "b": [True, False], "c": False}
    x = torch.arange(64 * 256.0).reshape(64, 256)
    assert torch.equal(zero_slice(x, 1, 2), x[32:]) and zero_slice(x, 1, 1) is x
    rng = np.random.RandomState(0)
    B = 5
    batch = Batch(wav=rng.randn(B, 3200).astype(np.float32),
                  wav_lens=np.full((B,), 3200, np.int32),
                  text_ids=rng.randint(1, 250, (B, 12)).astype(np.int32),
                  text_lens=np.full((B,), 12, np.int32),
                  response_ids=rng.randint(1, 250, (B, 8)).astype(np.int32),
                  response_lens=np.arange(1, B + 1, dtype=np.int32))
    padded = pad_batch_rows(batch, 4)
    assert padded.wav.shape[0] == 8 and padded.ctc_pool_ranges is None
    assert list(padded.response_lens) == [1, 2, 3, 4, 5, 0, 0, 0]
    np.testing.assert_array_equal(padded.wav[5], batch.wav[0])
    np.testing.assert_array_equal(padded.text_ids[7], batch.text_ids[0])
    assert pad_batch_rows(batch, 5) is batch
    shards = [torch_shard_batch(batch, r, 2) for r in range(2)]
    assert [s.wav.shape[0] for s in shards] == [3, 3]
    np.testing.assert_array_equal(shards[1].wav, pad_batch_rows(batch, 2).wav[3:6])
    assert list(shards[1].response_lens) == [4, 5, 0]


