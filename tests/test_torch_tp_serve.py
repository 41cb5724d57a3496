"""Tensor-parallel serving in the port (two gloo CPU ranks, one process
each) against the JAX package: the mirrors of ``tests/test_serve_mesh.py``
and the HTTP server under ``torch.distributed.run``.

The ranks run ``tests/torch_tp_worker.py`` once per case group: the dense,
paged and speculative slot decoders (float32 cache, and the int8 cache of
the dense and paged kernels), the int8 fused engine's ``generate``, and
the audio batch path, all on the tiny config's LLM (4 query heads, 2 KV
heads: tp = 2 shards the cache to one head a rank). The JAX reference runs
on its virtual 8-device mesh with model = 2 for the text prompts (as its
own tests run them) and unsharded for the audio batch path and the int8
slot decoders, on the same weights.

Token rows are held to the margin-aware contract (``tests/torch_streams.py``:
a row may part from JAX's only at a top-2 near-tie of the JAX model), and
rank 1's rows must equal rank 0's exactly.
"""

import json
import os
import re
import signal
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ring_worker import run_ranks
from torch_streams import LOGIT_DELTA, assert_streams_agree, recorded_rows
from torch_tp_worker import start_torchrun

from llm_speech_summarization_tpu.configs import load_config as jax_load_config
from llm_speech_summarization_tpu.infer.engine import LLMSpeechTextInference as JaxEngine
from llm_speech_summarization_tpu.infer.slots import SlotDecoder as JaxSlotDecoder
from llm_speech_summarization_tpu.models import llama as jllama
from llm_speech_summarization_tpu.parallel import mesh_from_devices
from llm_speech_summarization_tpu.utils.tokenizer import ByteTokenizer as JaxByteTokenizer
from llm_speech_summarization_tpu_torch import bridge
from llm_speech_summarization_tpu_torch.configs import YAML_DIR
from llm_speech_summarization_tpu_torch.train.checkpoint import export_encoder, save_params

torch.set_num_threads(1)

TINY_YAML = str(YAML_DIR / "tiny_test.yaml")
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
TEXTS = ["hello tensor parallel world", "the quick brown fox"]
BUDGET = 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _clips():
    rng = np.random.RandomState(0)
    return [(0.1 * rng.randn(n)).astype(np.float32) for n in (8000, 12000)]


@pytest.fixture(scope="module")
def ref():
    """The JAX side: a TP engine (model = 2) and an unsharded one on the same
    weights, their int8-weight twins, the prompts and the reference rows."""
    cfg = jax_load_config(TINY_YAML)
    je = JaxEngine(cfg)
    jt = JaxEngine(cfg, mesh=mesh_from_devices(data=4, model=2))
    cfg8 = jax_load_config(TINY_YAML)
    cfg8.model.llm_weight_dtype = "int8"
    jt8 = JaxEngine(cfg8, mesh=mesh_from_devices(data=4, model=2))
    embeds, mask = (np.asarray(x)[: len(TEXTS)] for x in jt.build_text_prompt_batch(TEXTS))
    with recorded_rows(JaxByteTokenizer) as rows:
        jt.generate_text_response_batch(TEXTS, max_new_tokens=BUDGET)
    with recorded_rows(JaxByteTokenizer) as rows8:
        jt8.generate_text_response_batch(TEXTS, max_new_tokens=BUDGET)
    with recorded_rows(JaxByteTokenizer) as audio_rows:
        je.generate_audio_response_batch(_clips(), max_new_tokens=BUDGET)
    a_embeds, a_mask = (np.asarray(x) for x in je.build_audio_prompt_batch(_clips()))
    return dict(je=je, jt=jt, jt8=jt8, embeds=embeds.astype(np.float32), mask=mask,
                rows=list(rows), rows8=list(rows8), audio_rows=list(audio_rows),
                audio_prompt=(a_embeds, a_mask))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Both ranks' outputs of the ``serve`` case group (one launch)."""
    d = tmp_path_factory.mktemp("tp_serve")
    je = ref["je"]
    torch.save({"config": TINY_YAML, "budget": BUDGET, "texts": TEXTS, "clips": _clips(),
                "embeds": torch.tensor(ref["embeds"]), "mask": torch.tensor(ref["mask"]),
                "llm_params": bridge.llama_params_from_numpy(_np(je.llm_params)),
                "llm_params_int8": bridge.llama_params_from_numpy(_np(ref["jt8"].llm_params)),
                "enc_params": bridge.encoder_params_from_numpy(_np(je.audio_encoder_params))},
               d / "inputs.pt")
    return run_ranks("serve", d, 2, timeout=240, script=WORKER)


def _text_prompt(ref, engine="jt"):
    def prompt_of(i):
        return ref[engine], ref["embeds"][i:i + 1], ref["mask"][i:i + 1]
    return prompt_of


def _same_on_both_ranks(ranks, key):
    r0, r1 = ranks[0][key], ranks[1][key]
    assert r1["rows"] == r0["rows"], f"{key}: rank 1's rows differ from rank 0's"
    return r0


@pytest.mark.parametrize("name", ["dense", "paged", "spec", "spec_paged"])
def test_tp_slot_decoders_match_jax(ref, ranks, name):
    """Dense and paged slot decoders, plain and speculative chunks, sharded
    over two ranks: the JAX TP engine's greedy rows, margin-aware, on both
    ranks; each rank's cache holds its one KV head."""
    got = _same_on_both_ranks(ranks, name)
    assert got["cache_heads"] == 1
    assert got["counts"]["prefills"] == 1
    assert got["counts"]["spec_rounds" if name.startswith("spec") else "steps"] > 0
    assert_streams_agree(ref["rows"], got["rows"], _text_prompt(ref))


def _jax_int8_rows(ref, paged):
    """The unsharded JAX slot decoder's rows on an int8 cache, same admission."""
    je = ref["je"]
    dec = JaxSlotDecoder(je.llm_params, je.llm_cfg, eos_id=je.tokenizer.eos_id, n_slots=4,
                         max_prompt_len=256, max_new_tokens=32, cache_dtype=jnp.int8,
                         paged=paged, page_size=64)
    n = len(TEXTS)
    dec.admit(jnp.asarray(ref["embeds"]), jnp.asarray(ref["mask"]), list(range(n)), [BUDGET] * n)
    rows = {}
    for _ in range(64):
        if dec.live_count() == 0:
            break
        dec.decode_chunk(4)
        rows.update({s: [int(t) for t in tok[:c]] for s, tok, c in dec.harvest()})
    return [rows[s] for s in range(n)]


def _int8_cache_margin(je, embeds, mask, prefix):
    """JAX's top-2 margin after ``prefix`` with the row's own tokens fed
    through an int8 KV cache step by step (what the slot decoder computes)."""
    cfg, p = je.llm_cfg, je.llm_params
    L = embeds.shape[1]
    cache = jllama.init_kv_cache(cfg, 1, L + len(prefix) + 1, dtype=jnp.int8)
    out = jllama.llama_forward(p, cfg, inputs_embeds=jnp.asarray(embeds),
                               attn_mask=jnp.asarray(mask), kv_cache=cache,
                               cache_offset=jnp.int32(0), last_logit_only=True)
    logits, cache = out.logits[0, -1], out.kv_cache
    n = int(mask.sum())
    for i, tok in enumerate(prefix):
        out = jllama.llama_forward(
            p, cfg, input_ids=jnp.asarray([[tok]], jnp.int32), attn_mask=None,
            positions=jnp.asarray([[n + i]], jnp.int32), kv_cache=cache,
            cache_offset=L + i, kv_pad_lens=jnp.asarray([L - n], jnp.int32))
        logits, cache = out.logits[0, 0], out.kv_cache
    top2 = np.sort(np.asarray(logits))[-2:]
    return float(top2[1] - top2[0])


@pytest.mark.parametrize("paged", [False, True])
def test_tp_int8_cache_decoders_match_jax(ref, ranks, paged):
    """The int8 cache (the kernels B2 and B5 on the card) sharded on its
    head axis: the JAX int8 slot decoder's rows, parting only at a near-tie
    of its int8-cache logits."""
    got = _same_on_both_ranks(ranks, "int8_paged" if paged else "int8_dense")
    assert got["cache_heads"] == 1
    want = _jax_int8_rows(ref, paged)
    for i, (a, b) in enumerate(zip(want, got["rows"])):
        if a == b:
            continue
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        margin = _int8_cache_margin(ref["je"], ref["embeds"][i:i + 1], ref["mask"][i:i + 1],
                                    a[:t])
        assert margin <= 2 * LOGIT_DELTA, (i, t, margin)


def test_tp_quantized_fused_params_shard_and_generate(ref, ranks):
    """int8 weights in the fused layout, sharded per rank as [q | k | v] and
    [gate | up] of the rank's heads and columns: ``generate`` on both ranks
    gives the JAX TP int8 engine's rows, margin-aware."""
    got = ranks[0]["int8_generate"]
    assert ranks[1]["int8_generate"]["rows"] == got["rows"]
    assert ranks[1]["int8_generate"]["texts"] == got["texts"]
    cfg = ref["je"].llm_cfg
    assert got["fused"] and got["wqkv_cols"] == (cfg.num_heads + 2 * cfg.num_kv_heads) \
        * cfg.head_dim // 2
    assert_streams_agree(ref["rows8"], got["rows"], _text_prompt(ref, "jt8"))


def test_tp_selects_fused_kernels(ranks):
    """Each rank's decode routes through the fused kernels' wrappers (B3 on
    the float cache, B2 on the int8 one, B5 paged, B4 for paged verify
    rounds; B1 for the admission prefill), at the rank's heads: 2 query
    heads over 1 KV head."""
    for r in ranks:
        by = {name: {k[0] for k in r[name]["kernels"]} for name in
              ("dense", "paged", "spec", "spec_paged", "int8_dense", "int8_paged")}
        assert by["dense"] == {"flash_attention", "fused_decode_attention_write"}
        assert by["int8_dense"] == {"flash_attention", "fused_decode"}
        assert by["paged"] == by["int8_paged"] == {"flash_attention", "fused_paged_decode"}
        assert "paged_decode_attention" in by["spec_paged"]
        assert "fused_decode_attention_write" in by["spec"]
        heads = {(q, kv) for name in by for _, q, kv in r[name]["kernels"]}
        assert heads == {(2, 1)}, heads


def test_tp_batch_path_audio(ref, ranks):
    """``generate_audio_response_batch`` SPMD on both ranks: rank 0 holds
    the encoder and broadcasts the prompt, rank 1 holds none; the JAX
    engine's rows, margin-aware, and the same rows and texts on both."""
    r0, r1 = ranks[0]["audio"], ranks[1]["audio"]
    assert (ranks[0]["builds_prompts"], ranks[0]["encoder_held"]) == (True, True)
    assert (ranks[1]["builds_prompts"], ranks[1]["encoder_held"]) == (False, False)
    assert r1["rows"] == r0["rows"] and r1["texts"] == r0["texts"]
    assert r0["counts"]["encoder_forwards"] == 1 and "encoder_forwards" not in r1["counts"]
    a_embeds, a_mask = ref["audio_prompt"]
    assert_streams_agree(ref["audio_rows"], r0["rows"],
                         lambda i: (ref["je"], a_embeds[i:i + 1], a_mask[i:i + 1]))


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_tp_http_e2e_under_torchrun(ref, tmp_path):
    """``cli/serve.py --tp 2`` under ``torch.distributed.run`` on two CPU
    ranks, on the JAX engine's weights (written with ``save_params`` and
    ``export_encoder``): greedy text requests one at a time give the JAX TP
    engine's rows, margin-aware; a burst of text, audio and streamed
    requests answers 200; SIGTERM to rank 0 drains it, rank 1 stops with it,
    and both exit 0 with equal harvested rows."""
    je = ref["je"]
    llm = save_params(str(tmp_path / "llm.pt"),
                      {"llm_params": bridge.llama_params_from_numpy(_np(je.llm_params))})
    enc = export_encoder(str(tmp_path / "enc.pt"),
                         bridge.encoder_params_from_numpy(_np(je.audio_encoder_params)))
    yaml = (YAML_DIR / "tiny_test.yaml").read_text().replace(
        "  llm_preset: tiny\n", f"  llm_preset: tiny\n  llm_checkpoint: {llm}\n")
    (tmp_path / "tiny.yaml").write_text(yaml)
    # port 0: rank 0's server binds a port of its own and names it in its
    # "serving on" line (a port picked here and released could be taken by
    # another process before the server binds it)
    proc = start_torchrun([WORKER, "serve_cli", str(tmp_path), "--", "-c",
                           str(tmp_path / "tiny.yaml"), "-p", enc, "--tp", "2",
                           "--device", "cpu", "--no_warmup", "--scheduler", "continuous",
                           "--host", "127.0.0.1", "--port", "0", "--slots", "4",
                           "--max_new_tokens", "16"], 2)
    log = []
    reader = threading.Thread(target=lambda: log.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        deadline, port = time.monotonic() + 120, None
        while True:
            assert proc.poll() is None, "".join(log)[-4000:]
            bound = re.search(r"serving on 127\.0\.0\.1:(\d+)", "".join(log))
            port = port or (bound and int(bound.group(1)))
            try:
                if port:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                timeout=5) as r:
                        if r.status == 200:
                            break
            except OSError:
                pass
            assert time.monotonic() < deadline, "".join(log)[-4000:]
            time.sleep(0.2)
        for text in TEXTS:  # one at a time: rank 0 decodes their rows in order
            status, body = _post(port, "/v1/text_response",
                                 {"text": text, "max_new_tokens": BUDGET})
            assert status == 200 and isinstance(body["response"], str)
        wav = _clips()[0]
        bodies = [("/v1/text_response", {"text": "a burst of requests", "max_new_tokens": 8}),
                  ("/v1/audio_summary", {"audio": wav.tolist(), "max_new_tokens": 6}),
                  ("/v1/text_response", {"text": "sampled", "max_new_tokens": 8,
                                         "temperature": 0.9, "top_k": 20, "seed": 3}),
                  ("/v1/audio_summary", {"audio": wav.tolist(), "max_new_tokens": 10,
                                         "stream": False})]
        results = [None] * len(bodies)
        threads = [threading.Thread(target=lambda i=i, b=b: results.__setitem__(i, _post(port, *b)))
                   for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert [r[0] for r in results] == [200] * len(bodies), results
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["requests_served"] == len(TEXTS) + len(bodies)
        with open(tmp_path / "rank0.pid") as f:
            os.kill(int(f.read()), signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, "".join(log)[-4000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        reader.join(10)
    out = [json.loads((tmp_path / f"serve_{r}.json").read_text()) for r in range(2)]
    assert out[1]["harvested"] == out[0]["harvested"]
    assert len(out[0]["harvested"]) == len(TEXTS) + len(bodies)
    assert out[0]["counts"] == out[1]["counts"]
    assert_streams_agree(ref["rows"], out[0]["decoded"][:len(TEXTS)], _text_prompt(ref))
