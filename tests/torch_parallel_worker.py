"""Rank processes for the port's data-, tensor- and 3-D-parallel training
tests (tests/test_torch_parallel_train.py).

``run_ranks(case, workdir, n, script=...)`` (``tests/torch_ring_worker.py``)
starts n processes of this file over gloo on the CPU, each with one
thread; each case reads ``workdir/inputs.pt`` and writes
``workdir/out_<rank>.pt``.

Cases:
  * ``steps`` (2 ranks): one KD step on each mesh the two ranks make, from
    the same weights: data 2 with the replicated optimizer and with ZeRO-1
    (the global batch split by ``shard_batch``; also two micro-steps of
    gradient accumulation with each), data 2 on a 3-row tail
    batch padded to 4, model 2 (the LLM sharded, without remat, with
    "full" and with "save_qkv"); and the vocab-parallel fused loss (float
    and int8 heads) with its gradient; the error of a model group's steps
    made without the whole embedding table;
  * ``steps3d`` (8 ranks): one step on the (data, seq, model) = (2, 2, 2)
    mesh with the ring, encoder SP, ZeRO-1 and the sharded LLM, beside each
    rank's coordinates and the members of its groups.
Every step returns the metrics, the updated encoder parameters and the
optimizer state.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _step(inp, mesh, batch, llm_params, zero=True, batches=1, **train):
    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset
    from llm_speech_summarization_tpu_torch.parallel.sharding import shard_batch
    from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves

    cfg = load_config(inp["config"])
    for key, value in train.items():
        setattr(cfg.train, key, value)
    # without ZeRO-1 the optimizer is replicated: no data group of its own
    state, opt = make_train_state(cfg, inp["enc_params"], 100,
                                  data_group=mesh.data_group if zero else None)
    step = make_train_step(cfg, encoder_setup_from_config(cfg), llama_preset("tiny"), opt,
                           inp["prefix"], inp["suffix"], inp["total_len"], device="cpu",
                           group=mesh.seq_group if cfg.train.use_ring_attention else None,
                           data_group=mesh.data_group, tp_group=mesh.model_group,
                           embed_table=inp["llm_params"] if mesh.model > 1 else None)
    for _ in range(batches):
        state, metrics = step(state, llm_params, shard_batch(batch, mesh.data_rank, mesh.data))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": [p.detach().clone() for p in tree_leaves(state.enc_params)],
            "mu": [m.clone() for m in tree_leaves(state.opt_state["mu"])],
            "whole_mu": [m.clone() for m in tree_leaves(
                opt.whole_state(state.opt_state, state.enc_params)["mu"])],
            "numel": [p.numel() for p in tree_leaves(state.enc_params)]}


def _fused(inp, mesh):
    from llm_speech_summarization_tpu_torch.ops.losses import fused_ntp_ld_losses

    out = {}
    n, r = mesh.model, mesh.model_rank
    for name, (head, scale) in inp["heads"].items():
        rows = head.shape[0] // n
        sh = inp["sh"].clone().requires_grad_()
        ntp, ld = fused_ntp_ld_losses(
            sh, inp["th"], head[r * rows:(r + 1) * rows], inp["labels"], inp["loss_mask"],
            inp["response_mask"], vocab_chunk=inp["vocab_chunk"],
            head_scale=None if scale is None else scale[r * rows:(r + 1) * rows],
            tp_group=mesh.model_group)
        (inp["w_ntp"] * ntp + inp["w_ld"] * ld).backward()
        out[name] = {"ntp": ntp.item(), "ld": ld.item(), "grad": sh.grad}
    return out


def _no_table(inp, mesh):
    """The error of a model group's train and eval steps made without the
    whole embedding table."""
    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset
    from llm_speech_summarization_tpu_torch.train import make_eval_step, make_train_step

    cfg = load_config(inp["config"])
    args = (cfg, encoder_setup_from_config(cfg), llama_preset("tiny"))
    errors = []
    for make, extra in ((make_train_step, (None,)), (make_eval_step, ())):
        try:
            make(*args, *extra, inp["prefix"], inp["suffix"], inp["total_len"], device="cpu",
                 tp_group=mesh.model_group)
        except ValueError as e:
            errors.append(str(e))
    return errors


def _steps(inp):
    from llm_speech_summarization_tpu_torch.parallel.mesh import mesh_from_ranks
    from llm_speech_summarization_tpu_torch.parallel.sharding import shard_llama_params
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset

    dp = mesh_from_ranks(data=2)
    tp = mesh_from_ranks(data=1, model=2)
    shard = shard_llama_params(inp["llm_params"], llama_preset("tiny"), tp.model_rank, 2)
    out = {"dp": _step(inp, dp, inp["batch"], inp["llm_params"], zero=False),
           "zero": _step(inp, dp, inp["batch"], inp["llm_params"]),
           "dp_accum": _step(inp, dp, inp["batch"], inp["llm_params"], zero=False, batches=2,
                             grad_accum_interval=2),
           "zero_accum": _step(inp, dp, inp["batch"], inp["llm_params"], batches=2,
                               grad_accum_interval=2),
           "tail": _step(inp, dp, inp["tail"], inp["llm_params"]),
           "fused": _fused(inp, tp)}
    out["no_table"] = _no_table(inp, tp)
    for name, remat, policy in (("tp", False, None), ("tp_full", True, "full"),
                                ("tp_save_qkv", True, "save_qkv")):
        out[name] = _step(inp, tp, inp["batch"], shard, remat=remat, remat_policy=policy)
    return out


def _steps3d(inp):
    import torch.distributed as dist

    from llm_speech_summarization_tpu_torch.models.llama import llama_preset
    from llm_speech_summarization_tpu_torch.parallel.mesh import mesh_from_ranks
    from llm_speech_summarization_tpu_torch.parallel.sharding import shard_llama_params

    mesh = mesh_from_ranks(data=2, seq=2, model=2)
    shard = shard_llama_params(inp["llm_params"], llama_preset("tiny"), mesh.model_rank, 2)

    def members(g):
        return dist.get_process_group_ranks(g)

    out = _step(inp, mesh, inp["batch"], shard, use_ring_attention=True, encoder_sp=True)
    out["coords"] = (mesh.data_rank, mesh.seq_rank, mesh.model_rank)
    out["groups"] = {"data": members(mesh.data_group), "seq": members(mesh.seq_group),
                     "model": members(mesh.model_group)}
    return out


CASES = {"steps": _steps, "steps3d": _steps3d}


def main() -> None:
    case, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from llm_speech_summarization_tpu_torch.parallel.mesh import distributed_init

    assert distributed_init(cpu=True)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = CASES[case](inp)
    torch.save(out, os.path.join(workdir, f"out_{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
