"""Rank processes for the port's tensor-parallel tests
(tests/test_torch_sharding.py, tests/test_torch_tp_serve.py).

``run_ranks(case, workdir, n)`` (``tests/torch_ring_worker.py``) starts n
processes of this file over gloo on the CPU, each with one thread; each
case reads ``workdir/inputs.pt`` and writes ``workdir/out_<rank>.pt``.

Cases: ``forward`` (prefill logits, decode logits and the cache shard of
the sharded ``llama_forward`` for each parameter tree and cache dtype,
beside the collectives and the mesh of the model group) and ``serve`` (the
mirrors of ``tests/test_serve_mesh.py``: dense, paged and speculative slot
decoders, the int8 fused engine and the audio batch path, every rank
making the same calls, with the kernels' head counts seen by a spy).

``serve_cli`` is each rank of ``cli/serve.py --tp`` under
``torch.distributed.run`` (``start_torchrun``): rank 0 writes its pid to
``workdir/rank0.pid`` (SIGTERM to it drains the server), and every rank
writes ``workdir/serve_<rank>.json`` when the CLI returns: the token rows
its decoder harvested and, on rank 0, the rows the server detokenized.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_ring_worker import LOCAL_RENDEZVOUS  # noqa: E402


def start_torchrun(script_args, n: int, cwd=ROOT) -> subprocess.Popen:
    """``python -m torch.distributed.run --nproc_per_node n <script_args>``
    in its own session (kill it with ``os.killpg``), output to a pipe; the
    rendezvous store on a port the launcher binds itself."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(n), *LOCAL_RENDEZVOUS, *script_args]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _forward(inp, mesh):
    import torch

    from llm_speech_summarization_tpu_torch.models import llama
    from llm_speech_summarization_tpu_torch.parallel import comm
    from llm_speech_summarization_tpu_torch.parallel.sharding import shard_llama_params

    cfg = llama.llama_preset("tiny")
    group, r = mesh.model_group, mesh.rank
    ids, pads, steps = inp["ids"], inp["pads"], inp["steps"]
    B, L = ids.shape
    mask = torch.arange(L)[None, :] >= pads[:, None]
    lens = mask.sum(1).to(torch.int32)
    out = {"mesh": (mesh.data, mesh.seq, mesh.model, mesh.rank, mesh.seq_group is None,
                    mesh.model_group is torch.distributed.group.WORLD)}
    for name, (tree, cache_dtype) in inp["variants"].items():
        shard = shard_llama_params(tree, cfg, r, mesh.model)
        cache = llama.init_kv_cache(cfg, B, L + steps, dtype=cache_dtype, tp=mesh.model)
        o = llama.llama_forward(shard, cfg, input_ids=ids, attn_mask=mask, kv_cache=cache,
                                cache_offset=0, tp_group=group)
        logits = [o.logits]
        tok = o.logits[:, -1].argmax(-1).to(torch.int32)
        for step in range(steps):
            o = llama.llama_forward(shard, cfg, input_ids=tok[:, None],
                                    positions=(lens + step)[:, None], kv_cache=cache,
                                    cache_offset=L + step, kv_pad_lens=(L - lens),
                                    tp_group=group)
            logits.append(o.logits)
            tok = o.logits[:, 0].argmax(-1).to(torch.int32)
        out[name] = {"logits": logits, "k": cache.k, "v": cache.v}
    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) * (r + 1)
    obj, tensors = comm.broadcast_call({"from": r} if r == 0 else None,
                                       [x, x > 2] if r == 0 else None, group)
    out["collectives"] = {"sum": comm.tp_all_reduce(x.clone(), group),
                          "gather": comm.tp_all_gather(x, -1, group),
                          "broadcast": (obj, tensors)}
    return out


def _harvest_all(dec, spec=False, k=4):
    rows = {}
    for _ in range(64):
        if dec.live_count() == 0:
            break
        dec.decode_chunk(k, spec=spec)
        rows.update({s: [int(t) for t in tok[:n]] for s, tok, n in dec.harvest()})
    assert dec.live_count() == 0
    return rows


def _serve(inp, mesh):
    import torch

    from torch_streams import recorded_rows

    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.infer.engine import LLMSpeechTextInference
    from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
    from llm_speech_summarization_tpu_torch.models import llama

    cfg = load_config(inp["config"])
    eng = LLMSpeechTextInference(cfg, device="cpu", llm_params=inp["llm_params"],
                                 audio_encoder_params=inp["enc_params"], mesh=mesh)
    embeds, mask, budget = inp["embeds"], inp["mask"], inp["budget"]
    n = embeds.shape[0]
    out = {"builds_prompts": eng.builds_prompts,
           "encoder_held": eng.audio_encoder_params is not None}

    # the kernels' wrappers as the forward calls them: (q heads, cache heads)
    seen = []

    head_axis = {"fused_decode": 2, "fused_decode_attention_write": 2, "fused_paged_decode": 2,
                 "paged_decode_attention": 1, "flash_attention": 2}  # of the k cache / k
    originals = {name: getattr(llama, name) for name in head_axis}

    def spy(name):
        def wrapped(*a, **kw):
            seen.append((name, a[0].shape[2], a[1].shape[head_axis[name]]))
            return originals[name](*a, **kw)
        return wrapped

    for name in head_axis:
        setattr(llama, name, spy(name))
    try:
        for name, paged, spec_k, cache_dtype in (("dense", False, 0, torch.float32),
                                                 ("paged", True, 0, torch.float32),
                                                 ("spec", False, 3, torch.float32),
                                                 ("spec_paged", True, 3, torch.float32),
                                                 ("int8_dense", False, 0, torch.int8),
                                                 ("int8_paged", True, 0, torch.int8)):
            seen.clear()
            dec = SlotDecoder(eng.llm_params, eng.llm_cfg, eos_id=eng.tokenizer.eos_id,
                              n_slots=4, max_prompt_len=256, max_new_tokens=32,
                              cache_dtype=cache_dtype, paged=paged, page_size=64,
                              spec_k=spec_k, mesh=mesh, device="cpu")
            dec.admit(embeds, mask, list(range(n)), [budget] * n)
            rows = _harvest_all(dec, spec=spec_k > 0, k=3 if spec_k else 4)
            cache = dec.state.cache
            out[name] = {"rows": [rows[s] for s in range(n)], "kernels": sorted(set(seen)),
                         "cache_heads": (cache.k_pool if paged else cache.k).shape[2],
                         "counts": dict(dec.counts)}
    finally:
        for k, fn in originals.items():
            setattr(llama, k, fn)

    tok_cls = type(eng.tokenizer)
    with recorded_rows(tok_cls) as rows:
        texts = eng.generate_audio_response_batch(inp["clips"], max_new_tokens=budget)
    out["audio"] = {"rows": list(rows), "texts": texts, "counts": dict(eng.counts)}

    cfg8 = load_config(inp["config"])
    cfg8.model.llm_weight_dtype = "int8"
    eng8 = LLMSpeechTextInference(cfg8, device="cpu", llm_params=inp["llm_params_int8"],
                                  audio_encoder_params=inp["enc_params"], mesh=mesh)
    with recorded_rows(tok_cls) as rows:
        texts = eng8.generate_text_response_batch(inp["texts"], max_new_tokens=budget)
    out["int8_generate"] = {"rows": list(rows), "texts": texts,
                            "fused": "wqkv" in eng8.llm_params["layers"],
                            "wqkv_cols": eng8.llm_params["layers"]["wqkv"].shape[-1]}
    return out


def serve_cli(workdir, cli_args) -> int:
    """One rank of ``cli/serve.py --tp``: the CLI's main() with every token
    row its decoder harvests (and, on rank 0, detokenizes) recorded."""
    import torch

    from torch_streams import recorded_rows

    from llm_speech_summarization_tpu_torch.cli import serve as cli
    from llm_speech_summarization_tpu_torch.infer.slots import SlotDecoder
    from llm_speech_summarization_tpu_torch.utils.tokenizer import ByteTokenizer

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    if rank == 0:
        with open(os.path.join(workdir, "rank0.pid"), "w") as f:
            f.write(str(os.getpid()))
    harvested, counts = [], {}
    harvest = SlotDecoder.harvest

    def recorded(self, flags=None):
        got = harvest(self, flags)
        harvested.extend([int(t) for t in tok[:n]] for _, tok, n in got)
        counts.update(self.counts)
        return got

    SlotDecoder.harvest = recorded
    with recorded_rows(ByteTokenizer) as rows:
        cli.main(cli_args)
    with open(os.path.join(workdir, f"serve_{rank}.json"), "w") as f:
        json.dump({"harvested": harvested, "decoded": list(rows), "counts": counts}, f)
    return 0


CASES = {"forward": _forward, "serve": _serve}


def _without_transformers(workdir) -> None:
    """A ``transformers`` that fails to import sends ``load_tokenizer`` to
    its byte fallback at once (the tests run offline; the real import takes
    seconds before the HF lookup fails)."""
    stub = os.path.join(workdir, "no_transformers")
    os.makedirs(os.path.join(stub, "transformers"), exist_ok=True)
    with open(os.path.join(stub, "transformers", "__init__.py"), "w") as f:
        f.write("raise ImportError('transformers is not used by this test')\n")
    sys.path.insert(0, stub)


def main() -> int:
    case, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, ROOT)
    _without_transformers(workdir)
    if case == "serve_cli":
        return serve_cli(workdir, sys.argv[4:])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from llm_speech_summarization_tpu_torch.parallel.mesh import distributed_init, mesh_from_ranks

    assert distributed_init(cpu=True)
    mesh = mesh_from_ranks(model=dist.get_world_size())
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = CASES[case](inp, mesh)
    torch.save(out, os.path.join(workdir, f"out_{mesh.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
