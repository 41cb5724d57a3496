"""Process groups and collectives (port of ``parallel/``): the mesh of
ranks and its ``seq`` group (``mesh.py``), and the collectives that the JAX
package gets from ``ppermute`` and GSPMD (``comm.py``)."""

from .comm import (
    COMM_STATS,
    all_gather,
    all_reduce_grads,
    any_rank,
    gather_tail,
    group_rank,
    group_size,
    halo_shift,
    ring_shift,
)
from .mesh import Mesh, check_backend, default_backend, distributed_init, make_mesh

__all__ = [
    "COMM_STATS",
    "Mesh",
    "all_gather",
    "all_reduce_grads",
    "any_rank",
    "check_backend",
    "default_backend",
    "distributed_init",
    "gather_tail",
    "group_rank",
    "group_size",
    "halo_shift",
    "make_mesh",
    "ring_shift",
]
