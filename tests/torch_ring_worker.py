"""Rank processes for the port's sequence-parallel tests
(tests/test_torch_ring_*.py), and the launcher that runs them.

``run_torchrun(module_args, n)`` runs a module through
``torch.distributed.run`` with the same care. ``run_ranks(case, workdir,
n)`` starts n processes of this file over gloo
on the CPU (``torch.distributed.run``'s environment: MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), each with one thread, and
joins them with a timeout of its own: a rank that fails or hangs fails the
call, and every rank is killed. Neither launcher picks a port and releases
it for the ranks to bind (under load another process took such a port
first): ``run_ranks`` hosts the rendezvous store itself on a port it binds
and keeps, and torchrun's agent binds its own (``LOCAL_RENDEZVOUS``). Each case reads ``workdir/inputs.pt``
(written by the test with ``torch.save``) and writes ``workdir/out_<rank>.pt``.

Cases: ``ring_attention`` (outputs and q/k/v gradients of this rank's
shard), ``hubert_sp`` (the frames of the sequence-parallel HuBERT),
``llama_ring`` (the ring llama_forward's global outputs and this rank's
part of the gradient of the input embeddings) and ``train_step`` (one KD
step over the seq group: metrics and updated encoder parameters).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, workdir, n: int, timeout: float = 120.0, script: str = None) -> list:
    """Run ``case`` on n ranks of ``script`` (default: this file); returns
    each rank's ``out_<rank>.pt``."""
    import torch

    # the store the ranks rendezvous on, bound here on a port of the
    # system's choosing and held until they have joined: every rank is a
    # client of it, as under torchrun's agent
    store = torch.distributed.TCPStore("127.0.0.1", 0, n, is_master=True,
                                       wait_for_workers=False)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(store.port),
               TORCHELASTIC_USE_AGENT_STORE="True",
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(script or __file__), case,
                               str(workdir)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
        del store
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if hung or failed:
        raise AssertionError(f"{case}: ranks {hung} hung past {timeout} s, ranks {failed} "
                             f"failed\n" + "\n".join(f"--- rank {r}:\n{log[-3000:]}"
                                                     for r, log in enumerate(logs)))
    return [torch.load(os.path.join(workdir, f"out_{r}.pt"), weights_only=False)
            for r in range(n)]


# torch.distributed.run's rendezvous on this host: its agent binds the store
# on a port of its own (port 0) and hands it to the ranks, so no port is
# picked here and released for the launch to take (under load another
# process took such a port first)
LOCAL_RENDEZVOUS = ("--rdzv-backend", "c10d", "--rdzv-endpoint", "127.0.0.1:0",
                    "--local-addr", "127.0.0.1")


def run_torchrun(module_args, n: int, timeout: float = 150.0, cwd=ROOT, path_first=()) -> str:
    """``python -m torch.distributed.run --nproc_per_node n -m <module_args>``
    on this host, with ``path_first`` ahead on the ranks' PYTHONPATH;
    returns its output. A failing or hanging run fails the call, and its
    whole process group is killed."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(n), *LOCAL_RENDEZVOUS, "-m", *module_args]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [*map(str, path_first), ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun {module_args} hung past {timeout} s:\n{out[-4000:]}")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {module_args} exited {proc.returncode}:\n{out[-4000:]}")
    return out


def _ring_attention(inp, group, r, n):
    import torch

    from llm_speech_summarization_tpu_torch.ops.ring_attention import ring_attention

    Tl = inp["q"].shape[1] // n
    q, k, v = (inp[x][:, r * Tl:(r + 1) * Tl].clone().requires_grad_() for x in "qkv")
    out = ring_attention(q, k, v, inp["starts"], group, causal=inp["causal"], ends=inp["ends"])
    (out * inp["w"][:, r * Tl:(r + 1) * Tl]).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _hubert_sp(inp, group, r, n):
    from llm_speech_summarization_tpu_torch.models.hubert import hubert_forward, hubert_preset

    frames, mask = hubert_forward(inp["params"], hubert_preset(inp["preset"]), inp["wav"],
                                  inp["wav_mask"], remat=inp.get("remat", False), sp_group=group)
    return {"frames": frames, "mask": mask}


def _llama_ring(inp, group, r, n):
    from llm_speech_summarization_tpu_torch.models.llama import llama_forward, llama_preset

    embeds = inp["embeds"].clone().requires_grad_()
    out = llama_forward(inp["params"], llama_preset(inp["preset"]), inputs_embeds=embeds,
                        attn_mask=inp["mask"], ring_group=group, **inp["kwargs"])
    loss = (out.final_hidden * inp["g_final"]).sum() + (out.hidden_states * inp["g_hidden"]).sum()
    loss.backward()
    return {"logits": out.logits.detach(), "hidden": out.hidden_states.detach(),
            "final": out.final_hidden.detach(), "grad_embeds": embeds.grad}


def _train_step(inp, group, r, n):
    from llm_speech_summarization_tpu_torch.configs import load_config
    from llm_speech_summarization_tpu_torch.models.audio_encoder import encoder_setup_from_config
    from llm_speech_summarization_tpu_torch.models.llama import llama_preset
    from llm_speech_summarization_tpu_torch.train import make_train_state, make_train_step
    from llm_speech_summarization_tpu_torch.train.state import tree_leaves

    cfg = load_config(inp["config"])
    for key, value in inp["train"].items():
        setattr(cfg.train, key, value)
    state, opt = make_train_state(cfg, inp["enc_params"], 100)
    step = make_train_step(cfg, encoder_setup_from_config(cfg), llama_preset("tiny"), opt,
                           inp["prefix"], inp["suffix"], inp["total_len"], device="cpu",
                           group=group)
    state, metrics = step(state, inp["llm_params"], inp["batch"])
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "params": [p.detach() for p in tree_leaves(state.enc_params)]}


CASES = {"ring_attention": _ring_attention, "hubert_sp": _hubert_sp,
         "llama_ring": _llama_ring, "train_step": _train_step}


def main() -> None:
    case, workdir = sys.argv[1], sys.argv[2]
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from llm_speech_summarization_tpu_torch.parallel.mesh import distributed_init

    assert distributed_init(cpu=True)
    assert dist.get_backend() == "gloo"
    r, n = dist.get_rank(), dist.get_world_size()
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = CASES[case](inp, dist.group.WORLD, r, n)
    torch.save(out, os.path.join(workdir, f"out_{r}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
