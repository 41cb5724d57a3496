"""K2, the absorbed latent decode over the int8 latent cache (``kernels/
latent_decode.py``; kernels named ``latent_decode_kernel`` and
``latent_merge_kernel``), against its roofline over the traced window: Σ
bound ms / Σ device ms, the device ms the trace's by kernel name, the bound
from the program's decode counters (latent slots attended, and the fresh
tokens: the decode pairs over k choices and the MoE layers, once a layer;
``work_moe.latent_work``); every call lies on the bytes side of the ridge.
The prefill's attention is a library call and not counted. None for a run
without them."""

from portbench import work_moe

LAYER = "kernels"
UNIT = "%"
MOVES = "utt_per_s"
SOURCE = "device_trace"
KERNELS = ("latent_decode_kernel", "latent_merge_kernel")


def read(run):
    w, ms = getattr(run, "moe_work", None), getattr(run, "kernel_ms", None)
    if not w or not ms:
        return None
    dev = sum(v for k, v in ms.items() if any(n in k for n in KERNELS))
    if dev <= 0:
        return None
    c = run.config
    d = w["decode"]
    moe_layers = c["num_hidden_layers"] - c["first_k_dense_replace"]
    fresh = d["pairs"] // (c["num_experts_per_tok"] * moe_layers) * c["num_hidden_layers"]
    return 100.0 * work_moe.phase_bound_ms(*work_moe.latent_work(d["latent_slots"], fresh, c)) / dev
