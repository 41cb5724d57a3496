"""Process groups of a multi-process run (port of ``parallel/mesh.py``).

The JAX package builds a ("data"[, "seq"], "model") device mesh and lets
XLA place the collectives. Here every rank is one process, and the mesh is
this rank's coordinates plus the process groups of its axes: ``data``, the
data-parallel replicas of the trainer (its gradient sum and ZeRO-1's
parameter gather), ``seq``, the sequence-parallel ring of the long-audio
trainer, and ``model``, the tensor-parallel group of the LLM in training
and serving (``parallel/sharding.py``). Ranks are laid out
rank = (d * seq + s) * model + m, as the JAX package reshapes its device
list, so a model group is a block of consecutive ranks.

``distributed_init`` joins the process group. Its backend follows from what
the rank sees (``default_backend``): NCCL with a card for each rank on the
host; gloo on the CPU, or with ranks that share a card (``parallel/comm.py``
stages CUDA tensors through the host for it). A caller may name the backend
instead; NCCL with more ranks on a host than cards then raises before the
init, because NCCL refuses a duplicate GPU in one communicator.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..configs import Config

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, ranks_on_host: int, cards: int) -> None:
    """Raise unless ``backend`` can run ``ranks_on_host`` ranks over
    ``cards`` visible CUDA cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and cards == 0:
        raise ValueError("the nccl backend needs CUDA cards; use 'gloo' on the CPU")
    if backend == "nccl" and ranks_on_host > cards:
        raise ValueError(
            f"nccl runs one rank per card, but {ranks_on_host} ranks share {cards} card(s) "
            f"on this host and NCCL refuses a duplicate GPU in one communicator; use the "
            f"'gloo' backend for ranks that share a card")


def default_backend(ranks_on_host: int, cards: int) -> str:
    """nccl with a card for each of the host's ranks, else gloo (the CPU, or
    ranks that share a card)."""
    return "nccl" if cards and ranks_on_host <= cards else "gloo"


def distributed_init(backend: Optional[str] = None, cpu: bool = False) -> bool:
    """Join the run's process group; True iff one is (now) initialized.

    Where the run is described, in this order:
      1. ``LSS_COORDINATOR`` (rank 0's host:port) + ``LSS_NUM_PROCESSES`` +
         ``LSS_PROCESS_ID``, a set, as the JAX package reads them;
      2. ``torch.distributed.run``'s ``MASTER_ADDR``, ``MASTER_PORT``,
         ``WORLD_SIZE`` and ``RANK``.
    One process, or neither: no-op, False. ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (set by ``torch.distributed.run``) place the ranks
    on this host's cards; without them every rank is taken to be on one
    host. With a card (and not ``cpu``), each rank's current device becomes
    card ``local_rank % device_count``. ``backend`` None: ``default_backend``
    of the host's ranks and cards (none with ``cpu``)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if env.get("LSS_COORDINATOR"):
        if "LSS_NUM_PROCESSES" not in env or "LSS_PROCESS_ID" not in env:
            raise ValueError("LSS_COORDINATOR is set but LSS_NUM_PROCESSES / LSS_PROCESS_ID "
                             "are missing: the three variables form a set")
        address = env["LSS_COORDINATOR"]
        num_processes = int(env["LSS_NUM_PROCESSES"])
        process_id = int(env["LSS_PROCESS_ID"])
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env.get("RANK", "0"))
    else:
        return False
    if num_processes <= 1:
        return False
    local_rank = int(env.get("LOCAL_RANK", process_id))
    ranks_on_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() and not cpu else 0
    backend = backend or default_backend(ranks_on_host, cards)
    check_backend(backend, ranks_on_host, cards)
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=process_id)
    return True


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, seq, model) mesh of ranks, laid out
    rank = (d * seq + s) * model + m, and the process groups of its axes:
    the ranks that differ from this one in that axis alone (None where the
    axis has one rank)."""

    data: int
    seq: int
    model: int
    rank: int
    seq_group: Any = None
    model_group: Any = None
    data_group: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes logs and checkpoints."""
        return self.rank == 0

    @property
    def data_rank(self) -> int:
        return self.rank // (self.seq * self.model)

    @property
    def seq_rank(self) -> int:
        return (self.rank // self.model) % self.seq

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def _axis_group(sizes, axis: int, rank: int):
    """The process group of ``axis`` (0 data, 1 seq, 2 model) that holds
    ``rank``: WORLD where the axis spans every rank, None where it has one.
    Every rank creates every group of the axis, in one order (a rank that
    skipped one would hang the others in ``new_group``)."""
    if sizes[axis] == 1:
        return None
    world = sizes[0] * sizes[1] * sizes[2]
    if sizes[axis] == world:
        return dist.group.WORLD
    strides = (sizes[1] * sizes[2], sizes[2], 1)
    mine = None
    for base in range(world):
        coords = (base // strides[0], (base // strides[1]) % sizes[1], base % sizes[2])
        if coords[axis]:
            continue  # each group once, from its member with coordinate 0
        ranks = [base + i * strides[axis] for i in range(sizes[axis])]
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def mesh_from_ranks(data: int = -1, model: int = 1, seq: int = 1) -> Mesh:
    """The (data, seq, model) mesh over the initialized process group (one
    process without one), the counterpart of the JAX ``mesh_from_devices``
    over processes; ``data`` -1 takes the ranks left over. Every rank must
    call it, with the same sizes: it creates the axes' process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    seq, model = max(seq, 1), max(model, 1)
    data = data if data != -1 else max(world // (seq * model), 1)
    if data * seq * model != world:
        raise ValueError(
            f"mesh {data},{seq},{model} needs {data * seq * model} ranks and this run has "
            f"{world}: launch it with python -m torch.distributed.run --nproc_per_node "
            f"{data * seq * model}")
    sizes = (data, seq, model)
    groups = [_axis_group(sizes, axis, rank) for axis in range(3)]
    return Mesh(data, seq, model, rank, seq_group=groups[1], model_group=groups[2],
                data_group=groups[0])


def make_mesh(cfg: Config) -> Mesh:
    """The mesh of ``cfg.train.mesh`` over the initialized process group."""
    m = cfg.train.mesh
    return mesh_from_ranks(m.data, m.model, m.seq)
