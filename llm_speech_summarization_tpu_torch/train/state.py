"""Train state and optimizer (port of ``train/state.py``).

The optimizer covers only the trainable audio-encoder parameters, kept in
float32. It is optax's chain, written out on the parameter trees so that
one step does what the JAX step does:

  * optional global-norm clipping (``optax.clip_by_global_norm``);
  * AdamW (``optax.adamw``: bias-corrected moments, eps 1e-8 outside the
    square root, decoupled weight decay) at the learning rate of
    ``lr_at``, evaluated at the optimizer's update count before the update;
  * with ``grad_accum_interval`` k > 1, k-step averaging
    (``optax.MultiSteps``): the running mean of k micro-step gradients is
    applied on every k-th step, and the other steps change no parameter.

Parameters and optimizer state are nested dicts/lists of tensors with the
JAX trees' keys, updated in place.

ZeRO-1 (a ``data_group`` of n > 1 ranks, as the JAX trainer shards
whenever its data axis has more than one device): each rank holds
only its slice of every moment (and accumulator) leaf that
``parallel/sharding.py::opt_state_spec`` shards, updates that slice of the
parameter from the reduced gradient, and all-gathers the parameters'
slices over the group afterwards, so every rank ends the step with the
whole encoder. Elementwise the update is the replicated optimizer's, bit
for bit: the clip's norm is taken over the whole reduced gradient (with
accumulation, over the accumulator gathered whole first). ``whole_state``
and ``slice_state`` convert the sharded state to the whole one (every rank
calls it: a collective) and back, for checkpoints.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import torch

from ..configs import Config
from ..parallel.comm import all_gather, group_rank, group_size
from ..parallel.sharding import zero_shards, zero_slice

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for key in tree for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@dataclass
class TrainState:
    step: int  # train steps taken (micro-steps with grad_accum_interval > 1)
    enc_params: Tree  # float32 leaves with requires_grad
    opt_state: Dict[str, Any]  # count, mini_step, mu, nu, acc (k > 1)


def lr_at(cfg: Config, total_opt_steps: int, step: int) -> float:
    """Learning rate at optimizer update ``step``: linear decay to 0 over
    ``total_opt_steps`` (the reference's PolynomialLR power 1), or with
    ``warmup_steps`` a linear warmup from 0 and a cosine decay to 0 (optax's
    warmup_cosine_decay_schedule); clamped past the end."""
    opt_cfg = cfg.train.optimizer
    t = min(step, total_opt_steps)
    if opt_cfg.warmup_steps > 0:
        warm = opt_cfg.warmup_steps
        decay = max(total_opt_steps, warm + 1)
        if t < warm:
            return opt_cfg.lr * t / warm
        frac = min(max((t - warm) / max(decay - warm, 1), 0.0), 1.0)
        return opt_cfg.lr * 0.5 * (1.0 + math.cos(math.pi * frac))
    total = max(total_opt_steps, 1)
    return opt_cfg.lr * max(1.0 - t / total, 0.0)


_SLICED = ("mu", "nu", "acc")  # the optimizer-state trees ZeRO-1 slices


class AdamW:
    """The optimizer of the KD step (see the module docstring)."""

    def __init__(self, cfg: Config, total_opt_steps: int, data_group=None):
        self.cfg = cfg
        self.total_opt_steps = total_opt_steps
        o = cfg.train.optimizer
        self.b1, self.b2, self.eps = o.beta1, o.beta2, 1e-8
        self.weight_decay = o.weight_decay
        self.clip = o.grad_clip_norm
        self.every_k = max(cfg.train.grad_accum_interval, 1)
        self.data_group = data_group
        self.n, self.rank = group_size(data_group), group_rank(data_group)
        self.zero = self.n > 1

    def _slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole leaf (all of it without ZeRO-1)."""
        return zero_slice(x, self.rank, self.n) if self.zero else x

    def _gather_into(self, leaves: List[torch.Tensor]) -> None:
        """Fill every sharded leaf of ``leaves`` (whole tensors, this rank's
        slice current) with the other ranks' slices: one all-gather."""
        sharded = [x for x in leaves if self.zero and zero_shards(x, self.n)]
        if not sharded:
            return
        parts = all_gather(torch.cat([self._slice(x).reshape(-1) for x in sharded]),
                           self.data_group, grad="slice")
        for q in range(self.n):
            i = 0
            for x in sharded:
                piece = zero_slice(x, q, self.n)
                piece.copy_(parts[q, i:i + piece.numel()].view_as(piece))
                i += piece.numel()

    def _whole(self, parts: List[torch.Tensor], like: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole float32 leaves from this rank's ``parts`` of leaves shaped
        like ``like`` (a collective under ZeRO-1)."""
        out = []
        for part, x in zip(parts, like):
            if part.shape == x.shape:
                out.append(part.clone())
            else:
                whole = torch.empty(x.shape, dtype=torch.float32, device=part.device)
                self._slice(whole).copy_(part)
                out.append(whole)
        self._gather_into(out)
        return out

    def init(self, params: Tree) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(self._slice(p), dtype=torch.float32)  # noqa: E731
        state = {"count": 0, "mini_step": 0, "mu": tree_map(zeros, params),
                 "nu": tree_map(zeros, params)}
        if self.every_k > 1:
            state["acc"] = tree_map(zeros, params)
        return state

    def whole_state(self, opt_state: Dict[str, Any], params: Tree) -> Dict[str, Any]:
        """``opt_state`` with every sliced tree whole (every rank of the data
        group calls it together under ZeRO-1); itself without ZeRO-1."""
        if not self.zero:
            return opt_state
        like = tree_leaves(params)
        out = dict(opt_state)
        for key in _SLICED:
            if key in opt_state:
                whole = iter(self._whole(tree_leaves(opt_state[key]), like))
                out[key] = tree_map(lambda _: next(whole), opt_state[key])
        return out

    def slice_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """A whole ``opt_state`` (from a checkpoint of any mesh) cut to this
        rank's slices; itself without ZeRO-1."""
        if not self.zero:
            return opt_state
        out = dict(opt_state)
        for key in _SLICED:
            if key in opt_state:
                out[key] = tree_map(lambda x: self._slice(x).clone(), opt_state[key])
        return out

    @torch.no_grad()
    def apply(self, state: TrainState, grads: List[torch.Tensor]) -> None:
        """Update ``state``'s parameters and optimizer state in place from
        whole (reduced) gradients in ``tree_leaves`` order."""
        opt = state.opt_state
        params = tree_leaves(state.enc_params)
        if self.every_k > 1:
            acc = tree_leaves(opt["acc"])
            n = opt["mini_step"]
            for a, g in zip(acc, grads):
                a.add_((self._slice(g).float() - a) / (n + 1))  # optax MultiSteps' mean
            if n + 1 < self.every_k:
                opt["mini_step"] = n + 1
                return
            grads = self._whole(acc, params)
            for a in acc:
                a.zero_()
            opt["mini_step"] = 0
        grads = [g.float() for g in grads]
        if self.clip is not None:
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            grads = [torch.where(norm < self.clip, g, g / norm * self.clip) for g in grads]
        lr = lr_at(self.cfg, self.total_opt_steps, opt["count"])
        opt["count"] += 1
        t = opt["count"]
        c1, c2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, m, v in zip(params, grads, tree_leaves(opt["mu"]), tree_leaves(opt["nu"])):
            p, g = self._slice(p), self._slice(g)
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            v.mul_(self.b2).add_((1.0 - self.b2) * g.square())
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(lr * u)
        self._gather_into(params)


def make_train_state(cfg: Config, enc_params: Tree, total_opt_steps: int, data_group=None):
    """(TrainState at step 0, its AdamW). ``enc_params`` become float32
    leaves that require gradients. ``data_group``: the data group of a
    data-parallel run, over which ZeRO-1 shards the optimizer state (without
    it the optimizer is replicated: each rank updates the whole state from
    the reduced gradients)."""
    params = tree_map(lambda p: p.detach().float().clone().requires_grad_(), enc_params)
    opt = AdamW(cfg, total_opt_steps, data_group)
    return TrainState(step=0, enc_params=params, opt_state=opt.init(params)), opt
