"""Tensor-parallel layouts, the ZeRO-1 rule and the batch shards (port of
``parallel/sharding.py``).

The JAX package states its layouts as PartitionSpecs and lets GSPMD place
the collectives. Here each rank is one process that holds its own shard,
made from the full tree by ``shard_llama_params``; ``models/llama.py``
runs a shard under the model group (``tp_group``), and its KV cache holds
the rank's KV heads (``init_kv_cache(..., tp=)``, and the paged pools at
``shard_config(cfg, tp).num_kv_heads``, as ``slot_state_spec`` shards the
JAX cache on its head axis).

The LLM is Megatron-style, as ``llama_param_spec``: the column-parallel
``wq/wk/wv/w_gate/w_up`` and their int8 scales split on the out axis, the
row-parallel ``wo/w_down`` on the in axis with their scales whole,
``embed_tokens`` (and its per-row scale) on the vocab rows and ``lm_head``
(and its scale) on the vocab columns; norms stay whole. Rank r takes query
heads [r·Hq/tp, (r+1)·Hq/tp), the KV heads that serve them, and the same
slice of the MLP's columns and of the vocab.

A fused ``wqkv`` shard is [the rank's q columns | its k columns | its v
columns] and ``w_gateup`` [its gate columns | its up columns], so the
forward's split of a fused product stays a plain slice. The JAX package
splits the fused axis contiguously instead, which crosses the Q|K|V
boundaries (its ``llama_param_spec`` docstring).

The audio encoder is not sharded (``encoder_param_spec`` replicates it):
in serving it stays whole on the rank that builds prompts, and the other
ranks hold none; in training every rank holds it whole.

Training over a data axis of n ranks:
  * ``opt_state_spec``: which optimizer-state leaves ZeRO-1 shards, the JAX
    rule: a leading dim divisible by n and at least ``ZERO_MIN_SIZE``
    elements; ``zero_slice`` is data rank d's part of such a leaf, rows
    [d·len/n, (d+1)·len/n) of its leading dim, and the whole of any other;
  * ``pad_batch_rows``: a batch padded to a multiple of n rows; the new
    rows copy row 0 with ``response_lens`` 0, so they add no loss, no
    token and no gradient;
  * ``shard_batch``: data rank d's rows of the (padded) global batch, the
    contiguous block that JAX's ``P("data")`` places on device d.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.batch import Batch
from ..models.llama import LlamaConfig, shard_config
from .comm import group_size

Params = Dict[str, Any]

# leaves every rank holds whole: the norms and the row-parallel products'
# per-out-channel scales (their out axis is the replicated hidden size)
WHOLE = frozenset({"input_norm", "post_attn_norm", "final_norm", "wo_scale", "w_down_scale"})


def _layout(cfg: LlamaConfig, name: str) -> Optional[Tuple[int, List[int]]]:
    """(axis, segment widths) along which leaf ``name`` splits, each segment
    in ``tp`` equal parts; None for a leaf every rank holds whole."""
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    inter, vocab = cfg.intermediate_size, cfg.vocab_size
    columns = {"wq": [q], "wk": [kv], "wv": [kv], "wqkv": [q, kv, kv],
               "w_gate": [inter], "w_up": [inter], "w_gateup": [inter, inter]}
    base = name[: -len("_scale")] if name.endswith("_scale") else name
    if name in WHOLE:
        return None
    if base in columns:
        return -1, columns[base]
    if name in ("wo", "w_down"):
        return -2, [q if name == "wo" else inter]
    if base == "embed_tokens":
        return 0, [vocab]
    if base == "lm_head":
        return -1, [vocab]
    raise KeyError(f"no tensor-parallel layout for the parameter {name!r}")


def _leaves(params: Params):
    """(path, name, leaf) of every leaf of a Llama tree."""
    for name, leaf in params.items():
        if name == "layers":
            for lname, lleaf in leaf.items():
                yield ("layers", lname), lname, lleaf
        else:
            yield (name,), name, leaf


def _put(tree: Params, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _check(x: torch.Tensor, name: str, axis: int, widths: Sequence[int]) -> None:
    if x.shape[axis] != sum(widths):
        raise ValueError(f"{name}: axis {axis} has {x.shape[axis]} entries, the config's "
                         f"layout {list(widths)} needs {sum(widths)}")


def shard_llama_params(params: Params, cfg: LlamaConfig, rank: int, tp: int) -> Params:
    """Rank ``rank``'s shard of a full Llama tree (plain, fused and/or int8)
    over a model group of ``tp`` ranks: new tensors, so the caller can drop
    the full tree. Raises ValueError when ``tp`` does not divide the heads,
    the MLP width or the vocab (``shard_config``)."""
    shard_config(cfg, tp)
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside a model group of {tp}")
    out: Params = {}
    for path, name, x in _leaves(params):
        layout = _layout(cfg, name)
        if layout is None:
            _put(out, path, x.clone())
            continue
        axis, widths = layout
        _check(x, name, axis, widths)
        parts = torch.split(x, list(widths), dim=axis)
        _put(out, path, torch.cat([p.narrow(axis, rank * (w // tp), w // tp)
                                   for p, w in zip(parts, widths)], dim=axis))
    return out


def merge_llama_shards(shards: Sequence[Params], cfg: LlamaConfig) -> Params:
    """The full tree from every rank's shard, in rank order (the inverse of
    ``shard_llama_params``); a whole leaf is rank 0's."""
    tp = len(shards)
    out: Params = {}
    per_rank = [list(_leaves(s)) for s in shards]
    for i, (path, name, x) in enumerate(per_rank[0]):
        xs = [leaves[i][2] for leaves in per_rank]
        layout = _layout(cfg, name)
        if layout is None:
            _put(out, path, x.clone())
            continue
        axis, widths = layout
        segments, offset = [], 0
        for w in widths:
            segments.append(torch.cat([s.narrow(axis, offset, w // tp) for s in xs], dim=axis))
            offset += w // tp
        _put(out, path, torch.cat(segments, dim=axis))
    return out


ZERO_MIN_SIZE = 16384  # smaller leaves stay replicated, as in the JAX rule


def zero_shards(x, n: int, min_size: int = ZERO_MIN_SIZE) -> bool:
    """True where ZeRO-1 shards the optimizer-state leaf ``x`` over a data
    axis of ``n`` ranks."""
    shape = tuple(getattr(x, "shape", ()))
    return n > 1 and len(shape) >= 1 and shape[0] % n == 0 and int(np.prod(shape)) >= min_size


def opt_state_spec(tree: Any, n: int, min_size: int = ZERO_MIN_SIZE) -> Any:
    """The tree of ``tree`` with True at every leaf ZeRO-1 shards over a
    data axis of ``n`` ranks (``zero_shards``), False elsewhere."""
    if isinstance(tree, dict):
        return {k: opt_state_spec(v, n, min_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [opt_state_spec(v, n, min_size) for v in tree]
    return zero_shards(tree, n, min_size)


def zero_slice(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Data rank ``rank``'s part of leaf ``x`` (a view): its block of the
    leading dim where ZeRO-1 shards the leaf, else all of it."""
    if not zero_shards(x, n):
        return x
    rows = x.shape[0] // n
    return x.narrow(0, rank * rows, rows)


def pad_batch_rows(batch: Batch, multiple: int) -> Batch:
    """``batch`` (host arrays) with its rows padded up to a multiple of
    ``multiple``: each new row copies row 0 (well-formed audio and text for
    every path) and has ``response_lens`` 0, so the splice gives it an
    empty loss and response mask and every loss and token count skips it."""
    B = batch.wav.shape[0]
    target = -(-B // multiple) * multiple
    if target == B:
        return batch

    def pad(x):
        if x is None:
            return None
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[:1], target - B, axis=0)], axis=0)

    padded = Batch(*(pad(x) for x in batch))
    resp_lens = padded.response_lens.copy()
    resp_lens[B:] = 0
    return padded._replace(response_lens=resp_lens)


def shard_batch(batch: Batch, rank: int, n: int) -> Batch:
    """Data rank ``rank``'s rows of the global ``batch`` over ``n`` data
    ranks, after ``pad_batch_rows``: rows [rank·B/n, (rank+1)·B/n)."""
    batch = pad_batch_rows(batch, n)
    rows = batch.wav.shape[0] // n
    return Batch(*(None if x is None else np.asarray(x)[rank * rows:(rank + 1) * rows]
                   for x in batch))
