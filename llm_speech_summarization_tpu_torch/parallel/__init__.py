"""Process groups and collectives (port of ``parallel/``): the mesh of
ranks and its ``data``, ``seq`` and ``model`` groups (``mesh.py``), the
collectives that the JAX package gets from ``ppermute`` and GSPMD
(``comm.py``), and the tensor-parallel layouts of the LLM, the ZeRO-1
rule and the batch shards (``sharding.py``, imported from its module: it
depends on ``models/``)."""

from .comm import (
    COMM_STATS,
    all_gather,
    all_reduce,
    all_reduce_grads,
    any_rank,
    broadcast_call,
    gather_tail,
    group_rank,
    group_size,
    halo_shift,
    max_over_ranks,
    ring_shift,
    tp_all_gather,
    tp_all_reduce,
    tp_copy,
)
from .mesh import (
    Mesh,
    check_backend,
    default_backend,
    distributed_init,
    make_mesh,
    mesh_from_ranks,
)

__all__ = [
    "COMM_STATS",
    "Mesh",
    "all_gather",
    "all_reduce",
    "all_reduce_grads",
    "any_rank",
    "broadcast_call",
    "check_backend",
    "default_backend",
    "distributed_init",
    "gather_tail",
    "group_rank",
    "group_size",
    "halo_shift",
    "make_mesh",
    "max_over_ranks",
    "mesh_from_ranks",
    "ring_shift",
    "tp_all_gather",
    "tp_all_reduce",
    "tp_copy",
]
