"""The collectives of the sequence- and tensor-parallel paths, over a
``torch.distributed`` process group: what the JAX package gets from
``jax.lax.ppermute`` inside ``shard_map`` and from GSPMD's inserted gathers
and reductions.

  * ``ring_shift``: every rank sends tensors to rank + 1 and receives from
    rank - 1 (wrapping around), sends and receives in one
    ``batch_isend_irecv`` so that no rank blocks its neighbour;
  * ``halo_shift``: the same without wraparound, one direction; the rank at
    the open end receives zeros (``models/hubert.py``'s conv halos). Its
    backward sends each halo's gradient back the other way;
  * ``all_gather``: the ranks' tensors stacked on a new leading axis. Its
    backward either sums the gradient over the ranks (``grad="sum"``: the
    downstream differs by rank, as the encoder frames in front of the
    replicated pool and projector, each rank's LLM shard seeing its part)
    or takes this rank's slice of it (``grad="slice"``: the downstream is
    computed the same on every rank, as a loss every rank computes);
  * ``gather_tail``: the last W positions of a sequence sharded along one
    axis, on every rank (``grad="slice"``);
  * ``all_reduce_grads``: the gradient sum over the group, in one flat
    float32 buffer;
  * ``any_rank``: a host flag or-ed over the group;
  * ``all_reduce``: a sum or a maximum over the group without autograd
    (the global loss denominators over the data group, the vocab-parallel
    loss's per-row statistics over the model group);
  * ``max_over_ranks``: a host integer's maximum over the group (the audio
    bucket every rank of a data-parallel run collates to);
  * the model group's Megatron pair: ``tp_all_reduce`` (the sum of the
    ranks' partial products after a row-parallel matmul and of the
    vocab-sharded embedding lookup, in the tensor's own dtype: gloo sums
    bfloat16; its backward passes the gradient through) and ``tp_copy``
    (the identity in front of the column-parallel products and the
    vocab-parallel loss, whose backward sums the ranks' partial gradients);
    ``tp_all_gather`` (the vocab-sharded logits, concatenated; its backward
    takes the rank's slice) and ``broadcast_call`` (one rank's host object
    and tensors, on every rank: the serving follower's commands and the
    prompts it decodes; no backward).

Under the gloo backend, CUDA tensors cross through host copies made here,
after a sync of the current stream (gloo's send, receive and gathers take
CPU tensors; it serves ranks that share one card, where NCCL refuses a
duplicate GPU in one communicator). Those copies add their bytes (device to
host and back) and the milliseconds of the whole exchange to
``COMM_STATS``. Under NCCL the tensors stay on the card and nothing is
recorded; that branch has not yet run on more than one card (PERF.md §7).
``group=None`` or a group of one rank makes every function the identity,
with no collective.
"""

from __future__ import annotations

import time
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

COMM_STATS = {"calls": 0, "bytes": 0, "ms": 0.0}  # host-staged exchanges only


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _peer(group, rank: int) -> int:
    """The global rank of ``rank`` of ``group`` (P2P ops take global ranks)."""
    return dist.get_global_rank(group, rank) if group is not dist.group.WORLD else rank


def _run(group, tensors: Sequence[torch.Tensor],
         op: Callable[[List[torch.Tensor]], List[torch.Tensor]]) -> List[torch.Tensor]:
    """``op`` on ``tensors`` where the backend takes them: under gloo, CUDA
    tensors go to the host first and ``op``'s outputs come back to the
    card, recorded in COMM_STATS."""
    tensors = [t.detach().contiguous() for t in tensors]
    dev = tensors[0].device
    if dev.type != "cuda" or dist.get_backend(group) != "gloo":
        return op(tensors)
    t0 = time.perf_counter()
    torch.cuda.current_stream(dev).synchronize()
    host = [t.to("cpu") for t in tensors]
    outs = [o.to(dev) for o in op(host)]
    COMM_STATS["calls"] += 1
    COMM_STATS["bytes"] += sum(t.numel() * t.element_size() for t in host + outs)
    COMM_STATS["ms"] += 1e3 * (time.perf_counter() - t0)
    return outs


def _p2p(group, sends, recvs) -> None:
    """Post every (tensor, peer) send and receive in one batch and wait."""
    ops = [dist.P2POp(dist.isend, t, _peer(group, p), group, tag=i)
           for i, (t, p) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, _peer(group, p), group, tag=i)
            for i, (t, p) in enumerate(recvs)]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor sent to rank + 1; returns those received from rank - 1
    (rank 0 receives from the last rank). No autograd."""
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return list(tensors)

    def op(ts):
        recv = [torch.empty_like(t) for t in ts]
        _p2p(group, [(t, (r + 1) % n) for t in ts], [(t, (r - 1) % n) for t in recv])
        return recv

    return _run(group, tensors, op)


def _shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)

    def op(ts):
        recv = torch.zeros_like(ts[0])
        dst, src = r + step, r - step
        _p2p(group, [(ts[0], dst)] if 0 <= dst < n else [],
             [(recv, src)] if 0 <= src < n else [])
        return [recv]

    return _run(group, [x], op)[0]


class _HaloShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, group):
        ctx.step, ctx.group = step, group
        return _shift(x, step, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.step, ctx.group), None, None


def halo_shift(x: torch.Tensor, step: int, group) -> torch.Tensor:
    """``step`` = +1: send ``x`` to rank + 1 and return what rank - 1 sent
    (zeros on rank 0); ``step`` = -1: send to rank - 1 and return what rank
    + 1 sent (zeros on the last rank). Every rank's ``x`` has one shape."""
    if step not in (1, -1):
        raise ValueError(f"halo_shift: step must be +1 or -1, got {step}")
    if group_size(group) == 1:
        return torch.zeros_like(x)
    return _HaloShift.apply(x, step, group)


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    n = group_size(group)

    def op(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(n)]
        dist.all_gather(parts, ts[0], group=group)
        return [torch.stack(parts)]

    return _run(group, [x], op)[0]


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    def run(ts):
        dist.all_reduce(ts[0], op=_OPS[op], group=group)
        return ts

    return _run(group, [x], run)[0]


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (``op`` "sum") or the maximum ("max") over the group of every
    rank's ``x``, on every rank, as a new tensor; no autograd."""
    if op not in _OPS:
        raise ValueError(f"all_reduce: op must be one of {sorted(_OPS)}, got {op!r}")
    if group_size(group) == 1:
        return x.detach()
    return _all_reduce(x.detach().clone(), group, op)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_sum):
        ctx.group, ctx.grad_sum = group, grad_sum
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = _all_reduce(g, ctx.group)
        return g[group_rank(ctx.group)], None, None


def all_gather(x: torch.Tensor, group, grad: str) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order. ``grad`` = "sum" or
    "slice" says what the backward does (see the module docstring)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"all_gather: grad must be 'sum' or 'slice', got {grad!r}")
    if group_size(group) == 1:
        return x[None]
    return _AllGather.apply(x, group, grad == "sum")


def gather_tail(x: torch.Tensor, W: int, dim: int, group) -> torch.Tensor:
    """The last ``W`` positions (``W`` = 0: all) of the sequence that the
    ranks hold in equal shards of ``x`` along ``dim``, on every rank; the
    gradient flows back to the shard that holds each position."""
    n, r = group_size(group), group_rank(group)
    dim = dim % x.dim()
    Tl = x.shape[dim]
    T = n * Tl
    W = W or T
    spans = [(max(T - W, q * Tl), min(T, (q + 1) * Tl)) for q in range(n)]
    lens = [max(hi - lo, 0) for lo, hi in spans]
    width = max(lens)
    piece = x.narrow(dim, max(spans[r][0] - r * Tl, 0), lens[r]) if lens[r] else x.narrow(dim, 0, 0)
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, width - lens[r]]
    stacked = all_gather(torch.nn.functional.pad(piece, pad), group, grad="slice")
    return torch.cat([stacked[q].narrow(dim, 0, lens[q]) for q in range(n) if lens[q]], dim)


def all_reduce_grads(grads: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The sum over the group of each gradient, as float32."""
    if group_size(group) == 1:
        return [g.float() for g in grads]
    flat = _all_reduce(torch.cat([g.float().reshape(-1) for g in grads]), group)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view(g.shape))
        i += g.numel()
    return out


def max_over_ranks(value: int, group) -> int:
    """The maximum over the group of a host integer, on every rank."""
    if group_size(group) == 1:
        return int(value)
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def any_rank(flag: bool, group) -> bool:
    """``flag`` or-ed over the group (a host value on every rank)."""
    return bool(max_over_ranks(int(bool(flag)), group))


class _TpAllReduce(torch.autograd.Function):
    """Megatron's g: the sum over the model group forward, the identity
    backward (every rank's gradient of the sum is the same)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpCopy(torch.autograd.Function):
    """Megatron's f: the identity forward, the sum over the model group
    backward (each rank's downstream holds its part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group).to(g.dtype), None


def tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of every rank's ``x`` (same shape and dtype),
    on every rank, bit-identical across them. Without a gradient to track,
    ``x`` is a temporary to the caller: where the backend takes it as it is
    (CPU tensors, NCCL), the sum is made in its storage. With one, the sum
    goes to a new tensor and the backward passes the gradient through."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _TpAllReduce.apply(x, group)
    return _all_reduce(x, group).to(x.dtype)


def tp_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself forward; backward, the sum over the group of the ranks'
    gradients (in front of a product whose weight is sharded over the
    group, so that the replicated input gets its whole gradient)."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _TpCopy.apply(x, group)


def tp_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on every
    rank; the backward takes this rank's part of the gradient (the
    downstream is computed the same on every rank)."""
    if group_size(group) == 1:
        return x
    return torch.cat(list(all_gather(x, group, grad="slice").unbind(0)), dim=dim)


def broadcast_call(obj, tensors, group, src: int = 0, device=None):
    """(obj, tensors) of group rank ``src`` on every rank: a picklable host
    object and a list of tensors, which the other ranks pass as None and
    receive on ``device``. One object broadcast carries ``obj`` and the
    tensors' shapes and dtypes, then one broadcast per tensor."""
    if group_size(group) == 1:
        return obj, list(tensors)
    me = group_rank(group)
    head = [(obj, [(tuple(t.shape), t.dtype) for t in tensors]) if me == src else None]
    dist.broadcast_object_list(head, src=_peer(group, src), group=group)
    obj, specs = head[0]
    if me != src:
        tensors = [torch.empty(shape, dtype=dtype, device=device) for shape, dtype in specs]
    out = []
    for t in tensors:
        def op(ts):
            dist.broadcast(ts[0], src=_peer(group, src), group=group)
            return ts

        out.append(_run(group, [t], op)[0])
    return obj, out
