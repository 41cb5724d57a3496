"""The port's tensor-parallel layouts (``parallel/sharding.py``) and the
sharded ``llama_forward`` against the JAX package.

``shard_llama_params`` and ``merge_llama_shards`` round-trip the plain,
fused and int8 trees bit for bit; a fused shard's columns are its heads'
unfused columns; widths that do not divide the group raise, as does a data
axis. The sharded forward on two gloo CPU ranks (``tests/torch_tp_worker.py``,
one launch for every case) gives the unsharded JAX ``llama_forward``'s
prefill and decode logits within the JAX float32 tests' tolerance (atol
1e-4, as ``tests/test_torch_models.py``), on both ranks alike, and its
cache holds the JAX cache's heads of the rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ring_worker import run_ranks

from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
from llm_speech_summarization_tpu_torch.models import llama as tllama
from llm_speech_summarization_tpu_torch.parallel.mesh import Mesh, make_mesh
from llm_speech_summarization_tpu_torch.parallel.sharding import (
    merge_llama_shards,
    shard_llama_params,
)

torch.set_num_threads(1)

WORKER = __file__.replace("test_torch_sharding.py", "torch_tp_worker.py")
LOGIT_ATOL = 1e-4  # the JAX float32 tests' bound on llama logits
CACHE_ATOL = 1e-5  # float cache contents: the projections themselves
TREES = ("plain", "fused", "int8_fused", "int8_plain")


def _jax_tree(kind, seed=1):
    cfg = jllama.llama_preset("tiny")
    p = jllama.init_llama_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    if kind in ("fused", "int8_fused"):
        p = jllama.fuse_llama_params(p)
    if kind.startswith("int8"):
        p = jllama.quantize_llama_params(p)
    return p


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", TREES)
def test_shard_merge_round_trip(kind):
    """The JAX tree carried into each rank's shard (``bridge``) and merged
    back is the full tree bit for bit; each shard's leaves have the rank's
    widths."""
    cfg = tllama.llama_preset("tiny")
    tree = _np(_jax_tree(kind))
    full = bridge.llama_params_from_numpy(tree)
    shards = [bridge.llama_shard_from_numpy(tree, cfg, r, 2) for r in range(2)]
    assert _equal(merge_llama_shards(shards, cfg), full)
    layers = shards[1]["layers"]
    q, kv = cfg.num_heads * cfg.head_dim // 2, cfg.num_kv_heads * cfg.head_dim // 2
    assert layers["wo"].shape[1:] == (q, cfg.hidden_size)
    assert layers["w_down"].shape[1] == cfg.intermediate_size // 2
    assert shards[1]["embed_tokens"].shape[0] == cfg.vocab_size // 2
    if "wqkv" in layers:
        assert layers["wqkv"].shape[-1] == q + 2 * kv
    if kind.startswith("int8"):
        assert torch.equal(layers["wo_scale"], full["layers"]["wo_scale"])  # row-parallel: whole


def test_fused_shard_columns_are_the_heads_columns():
    """Rank r's ``wqkv`` is [its q heads | its kv heads of k | of v] of the
    unfused ``wq/wk/wv``, and its ``w_gateup`` [its gate | its up] columns."""
    cfg = tllama.llama_preset("tiny")
    plain = bridge.llama_params_from_numpy(_np(_jax_tree("plain")))
    fused = tllama.fuse_llama_params(plain)
    q, kv, inter = (cfg.num_heads * cfg.head_dim // 2, cfg.num_kv_heads * cfg.head_dim // 2,
                    cfg.intermediate_size // 2)
    for r in range(2):
        s = shard_llama_params(fused, cfg, r, 2)["layers"]
        p = plain["layers"]
        want = torch.cat([p["wq"][..., r * q:(r + 1) * q], p["wk"][..., r * kv:(r + 1) * kv],
                          p["wv"][..., r * kv:(r + 1) * kv]], dim=-1)
        assert torch.equal(s["wqkv"], want)
        assert torch.equal(s["w_gateup"], torch.cat([p["w_gate"][..., r * inter:(r + 1) * inter],
                                                     p["w_up"][..., r * inter:(r + 1) * inter]],
                                                    dim=-1))


def test_widths_that_do_not_divide_raise():
    """A group size that does not divide the heads raises, naming them, in
    the sharding, the decoder and the engine."""
    cfg = tllama.llama_preset("tiny")
    plain = bridge.llama_params_from_numpy(_np(_jax_tree("plain")))
    with pytest.raises(ValueError, match="num_heads=4, num_kv_heads=2"):
        shard_llama_params(plain, cfg, 0, 3)
    with pytest.raises(ValueError, match="num_kv_heads=2"):
        SlotDecoder(plain, cfg, eos_id=0, mesh=Mesh(1, 1, 3, 0), device="cpu")
    with pytest.raises(ValueError, match="num_heads=4"):
        LLMSpeechTextInference(load_config(str(YAML_DIR / "tiny_test.yaml")), device="cpu",
                               mesh=Mesh(1, 1, 3, 0))
    with pytest.raises(KeyError, match="no tensor-parallel layout"):
        shard_llama_params({**plain, "extra": plain["final_norm"]}, cfg, 0, 2)


def test_data_axis_raises_naming_the_training_slice():
    """A data axis is a mesh axis like the others (its ranks train the
    slice's data-parallel step, tests/test_torch_parallel_train.py): in one
    process a data axis of 2 asks for its ranks, data -1 takes the one
    process, and a rank's coordinates follow rank = (d·seq + s)·model + m."""
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    cfg.train.mesh.data = 2
    with pytest.raises(ValueError, match="needs 2 ranks.*--nproc_per_node 2"):
        make_mesh(cfg)
    cfg.train.mesh.data = -1
    assert make_mesh(cfg).data == 1
    coords = [(m.data_rank, m.seq_rank, m.model_rank)
              for m in (Mesh(2, 2, 2, r) for r in range(8))]
    assert coords == [(d, s, t) for d in range(2) for s in range(2) for t in range(2)]


@pytest.fixture(scope="module")
def forward_runs(tmp_path_factory):
    """Both ranks' outputs of the ``forward`` case (one launch), and the
    JAX trees, inputs and unsharded outputs they are held to."""
    d = tmp_path_factory.mktemp("tp_forward")
    B, L, steps = 3, 12, 3
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 512, size=(B, L)).astype(np.int32)
    pads = np.array([3, 0, 1], np.int32)
    variants = {f"{kind}_{cache}": (kind, cache) for kind in ("plain", "int8_fused")
                for cache in ("float32", "int8")}
    trees = {kind: _jax_tree(kind) for kind in ("plain", "int8_fused")}
    inputs = {"ids": torch.from_numpy(ids), "pads": torch.from_numpy(pads), "steps": steps,
              "variants": {name: (bridge.llama_params_from_numpy(_np(trees[kind])),
                                  torch.int8 if cache == "int8" else torch.float32)
                           for name, (kind, cache) in variants.items()}}
    torch.save(inputs, d / "inputs.pt")
    outs = run_ranks("forward", d, 2, timeout=120, script=WORKER)

    cfg = jllama.llama_preset("tiny")
    mask = np.arange(L)[None, :] >= pads[:, None]
    lens = mask.sum(1).astype(np.int32)
    want = {}
    for name, (kind, cache) in variants.items():
        p = trees[kind]
        out = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(ids), attn_mask=jnp.asarray(mask),
                                   kv_cache=jllama.init_kv_cache(cfg, B, L + steps,
                                                                 dtype=jnp.dtype(cache)),
                                   cache_offset=jnp.int32(0))
        logits, jcache = [np.asarray(out.logits)], out.kv_cache
        tok = np.asarray(jnp.argmax(out.logits[:, -1], -1)).astype(np.int32)
        for step in range(steps):
            out = jllama.llama_forward(p, cfg, input_ids=jnp.asarray(tok[:, None]), attn_mask=None,
                                       positions=jnp.asarray((lens + step)[:, None]),
                                       kv_cache=jcache, cache_offset=L + step,
                                       kv_pad_lens=jnp.asarray(pads))
            logits.append(np.asarray(out.logits))
            jcache = out.kv_cache
            tok = np.asarray(jnp.argmax(out.logits[:, 0], -1)).astype(np.int32)
        want[name] = {"logits": logits, "k": np.asarray(jcache.k, np.float32),
                      "v": np.asarray(jcache.v, np.float32)}
    return outs, want, mask


@pytest.mark.parametrize("name", ["plain_float32", "plain_int8", "int8_fused_float32",
                                  "int8_fused_int8"])
def test_tp_forward_matches_jax(forward_runs, name):
    """Prefill and three decode steps of the sharded forward on two ranks:
    the unsharded JAX logits within ``LOGIT_ATOL`` on both ranks, the same
    on both bit for bit; each rank's cache has its one KV head."""
    outs, want, mask = forward_runs
    w = want[name]
    for r, out in enumerate(outs):
        got = out[name]
        assert got["k"].shape[2] == 1
        np.testing.assert_allclose(got["logits"][0].numpy()[mask], w["logits"][0][mask],
                                   atol=LOGIT_ATOL, rtol=0)
        for step in range(1, len(w["logits"])):
            np.testing.assert_allclose(got["logits"][step].numpy(), w["logits"][step],
                                       atol=LOGIT_ATOL, rtol=0)
        for a, b in zip(got["logits"], outs[0][name]["logits"]):
            assert torch.equal(a, b)
        if name.endswith("float32"):  # the rank's head of the JAX cache
            for f in ("k", "v"):
                np.testing.assert_allclose(got[f].numpy(), w[f][:, :, r:r + 1],
                                           atol=CACHE_ATOL, rtol=0)


def test_model_group_collectives_and_mesh(forward_runs):
    """The model group of ``mesh_from_ranks(model=2)`` is the world's; its
    sum, gather and broadcast give every rank the same values."""
    outs, _, _ = forward_runs
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    for r, out in enumerate(outs):
        assert out["mesh"] == (1, 1, 2, r, True, True)
        c = out["collectives"]
        assert c["sum"].dtype == torch.bfloat16 and torch.equal(c["sum"], 3 * x)
        assert torch.equal(c["gather"], torch.cat([x, 2 * x], dim=-1))
        obj, (t, m) = c["broadcast"]
        assert obj == {"from": 0} and torch.equal(t, x) and torch.equal(m, x > 2)
