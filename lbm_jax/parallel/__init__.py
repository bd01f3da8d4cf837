from lbm_jax.parallel.mesh import lattice_mesh, lattice_sharding, shard_case
from lbm_jax.parallel.halo import make_halo_step

__all__ = [
    "lattice_mesh",
    "lattice_sharding",
    "shard_case",
    "make_halo_step",
]
