"""Bridge: the JAX package's parameter pytrees, decoder state and training
batches, with numpy leaves (``jax.tree.map(np.asarray, tree)``), → the
port's tensors, and back; a model group rank's shard of a Llama tree and a
data rank's ZeRO-1 slices of optimizer moments.

Keys and layouts are kept as they are: the stacked ``(L, in, out)`` Llama
layers, fused ``wqkv`` / ``w_gateup``, int8 weights with their bf16
``*_scale`` leaves, HuBERT's list of conv layers, Whisper's stacked layers
and its conv weights, which the JAX package already keeps in the torch
``(out, in, k)`` layout. bfloat16 numpy arrays (ml_dtypes) cross bit for
bit through a 16-bit integer view.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .data.batch import Batch
from .infer.paged import PagedKVCache
from .infer.slots import SlotState
from .models.llama import KVCache
from .parallel.sharding import shard_llama_params, zero_slice


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) → a tensor with its own storage."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device) if device is not None else t


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor → numpy; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree, device=None):
    """A JAX parameter pytree with numpy leaves → the same tree of tensors:
    Llama params (plain, fused and/or int8-quantized) or audio-encoder params
    ({"encoder", "proj_w", "proj_b"}, or a bare HuBERT or Whisper tree)."""
    return _map(tree, lambda a: tensor_from_numpy(a, device))


llama_params_from_numpy = params_from_numpy
encoder_params_from_numpy = params_from_numpy


def llama_shard_from_numpy(tree, cfg, rank: int, tp: int, device=None):
    """A JAX Llama pytree with numpy leaves → rank ``rank``'s shard of it
    over a model group of ``tp`` ranks (``parallel/sharding.py``)."""
    return shard_llama_params(params_from_numpy(tree, device), cfg, rank, tp)


def zero_slices_from_numpy(tree, rank: int, n: int, device=None):
    """A tree with numpy leaves (the JAX optimizer's moments of the encoder)
    → data rank ``rank``'s ZeRO-1 slices of it over ``n`` data ranks: the
    leaves ``parallel/sharding.py::opt_state_spec`` shards cut to their
    block of the leading dim, the others whole."""
    return _map(tree, lambda a: zero_slice(tensor_from_numpy(a, device), rank, n).clone())


def batch_from_numpy(batch) -> Batch:
    """A JAX training ``Batch`` (numpy fields) → the port's host ``Batch``;
    the train and eval steps move it to their device. The same encoder
    parameters start both packages' optimizers from zero moments, so
    ``params_from_numpy`` and this are all a train step needs."""
    return Batch(*(None if a is None else np.asarray(a) for a in batch))


def kv_cache_from_numpy(k, v, k_scale: Optional[Any] = None, v_scale: Optional[Any] = None,
                        device=None) -> KVCache:
    """A JAX ``KVCache``'s fields → the port's ``KVCache``, each field in
    its own storage (the cache is written in place)."""
    conv = lambda a: None if a is None else tensor_from_numpy(a, device)  # noqa: E731
    return KVCache(conv(k), conv(v), conv(k_scale), conv(v_scale))


def params_to_numpy(tree):
    """Port tensors → numpy leaves (bfloat16 as float32), for comparisons."""
    return _map(tree, tensor_to_numpy)


def paged_cache_from_numpy(cache, device=None) -> PagedKVCache:
    """A JAX ``PagedKVCache`` with numpy leaves → the port's, each field in
    its own storage."""
    conv = lambda a: None if a is None else tensor_from_numpy(a, device)  # noqa: E731
    return PagedKVCache(*(conv(getattr(cache, f)) for f in PagedKVCache._fields))


def slot_state_from_numpy(state, device=None) -> SlotState:
    """A JAX ``SlotState`` with numpy leaves (dense or paged cache) → the
    port's. The uint32 seed words widen to int64; a paged cache's lengths
    and pads become the state's offsets and pads tensors themselves, as in
    the port's decoder."""
    t = {f: tensor_from_numpy(getattr(state, f), device)
         for f in SlotState._fields if f != "cache"}
    t["rng"] = t["rng"].to(torch.int64)
    if hasattr(state.cache, "k_pool"):
        cache = paged_cache_from_numpy(state.cache, device)._replace(
            lengths=t["offsets"], pad_lens=t["pad_lens"])
    else:
        c = state.cache
        cache = kv_cache_from_numpy(c.k, c.v, c.k_scale, c.v_scale, device)
    return SlotState(cache=cache, **t)
