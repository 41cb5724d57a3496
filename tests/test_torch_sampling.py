"""The port's per-row sampler against the JAX package's (the same draws bit
for bit: the counter hash is integer arithmetic), the committed sampled-
tokens golden through the port's generation loop, and the one-temperature
sampler's contract."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.infer import sampling as jsampling
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.infer import sampling
from llm_speech_summarization_tpu_torch.infer.generate import _sample, greedy_generate
from llm_speech_summarization_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

GOLDEN = Path(__file__).resolve().parent / "goldens" / "sampled_tokens_tiny.json"


def _rows(seed, N=16, V=300):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, V) * 3.0).astype(np.float32)
    keys = np.stack([jsampling.key_data_from_seed(int(s))
                     for s in rng.randint(0, 2**62, size=N, dtype=np.int64)])
    positions = rng.randint(0, 5000, size=N).astype(np.int32)
    temps = rng.choice([0.0, 0.5, 1.0, 1.7], size=N).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 40, 200], size=N).astype(np.int32)
    top_ps = rng.choice([1.0, 0.9, 0.5, 0.05], size=N).astype(np.float32)
    return logits, keys, positions, temps, top_ks, top_ps


def _torch(arrays):
    logits, keys, positions, temps, top_ks, top_ps = arrays
    return (torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(positions), torch.from_numpy(temps), torch.from_numpy(top_ks),
            torch.from_numpy(top_ps))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_rows_matches_jax(seed):
    arrays = _rows(seed)
    want = jsampling.sample_rows(*map(jnp.asarray, arrays))
    got = sampling.sample_rows(*_torch(arrays))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_uniform_rows_bit_exact():
    _, keys, positions, *_ = _rows(3, N=64)
    positions = positions.copy()
    positions[:4] = [0, -1, 2**31 - 1, -(2**31)]  # wrap like uint32
    want = jsampling._uniform_rows(jnp.asarray(keys), jnp.asarray(positions))
    got = sampling._uniform_rows(torch.from_numpy(keys.astype(np.int64)),
                                 torch.from_numpy(positions))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_sampling_params_matches_jax():
    spec = [None, (0.9, 0, 1.0, 1234), (1.3, 8, 1.0, 2**63 + 5), None]
    for a, b in zip(sampling.pack_sampling_params(spec, 5),
                    jsampling.pack_sampling_params(spec, 5)):
        np.testing.assert_array_equal(a, b)
    assert sampling.pack_sampling_params([None, None], 2) is None
    np.testing.assert_array_equal(sampling.key_data_from_seed(-3),
                                  jsampling.key_data_from_seed(-3))


def _golden_params(g):
    cfg = jllama.llama_preset(g["llm_preset"])
    p = jllama.init_llama_params(jax.random.PRNGKey(g["param_seed"]), cfg, dtype=jnp.float32)
    return bridge.llama_params_from_numpy(jax.tree.map(np.asarray, p))


def _golden_run(g, params, rows):
    ids = torch.tensor(np.asarray(g["prompt_ids"])[rows], dtype=torch.long)
    mask = torch.tensor(np.asarray(g["prompt_mask"])[rows].astype(bool))
    spec = [tuple(g["sampling"][r]) if g["sampling"][r] else None for r in rows]
    packed = sampling.pack_sampling_params(spec, len(rows))
    toks, lens = greedy_generate(
        params, tllama.llama_preset(g["llm_preset"]), params["embed_tokens"][ids], mask,
        max_new_tokens=g["max_new_tokens"], eos_id=g["eos_id"], cache_dtype=torch.float32,
        sampling=None if packed is None else sampling.sampling_tensors(packed, "cpu"),
    )
    return toks.tolist(), lens.tolist()


def test_sampled_tokens_golden():
    """The committed seeded stream (mixed greedy and sampling rows, a
    left-padded row) through the port's generation loop, and the padded
    sampling row replayed alone without its padding."""
    g = json.loads(GOLDEN.read_text())
    params = _golden_params(g)
    toks, lens = _golden_run(g, params, [0, 1, 2, 3])
    assert toks == g["tokens"]
    assert lens == g["lengths"]
    pad = sum(1 for m in g["prompt_mask"][1] if not m)
    g1 = dict(g, prompt_ids=[g["prompt_ids"][1][pad:]], prompt_mask=[[1] * (16 - pad)],
              sampling=[g["sampling"][1]])
    assert _golden_run(g1, params, [0])[0][0] == g["tokens"][1]


def test_one_temperature_sampler():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy((rng.randn(5, 40) * 2).astype(np.float32))
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(_sample(logits, 0.0, None), greedy)
    # top_k=1 and a degenerate top_p leave only the argmax
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(_sample(logits, 0.8, gen, top_k=1), greedy)
    assert torch.equal(_sample(logits, 0.8, gen, top_p=1e-6), greedy)
    draws = [_sample(logits, 1.0, torch.Generator().manual_seed(7), top_k=5) for _ in range(2)]
    assert torch.equal(draws[0], draws[1])  # the same generator seed replays
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert (top5 == draws[0][:, None].long()).any(dim=1).all()
