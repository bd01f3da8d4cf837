"""Device mesh + sharding for spatial domain decomposition (GSPMD path).

The reference is strictly single-GPU (SURVEY.md section 2.4: no MPI/NCCL,
no multi-device anywhere). The scale-out here is 1-D spatial
decomposition of the lattice over a `jax.sharding.Mesh`: each device owns
a contiguous slab plus the implicit one-cell halo that `jnp.roll` needs —
under jit, XLA's SPMD partitioner turns the rolls into halo
CollectivePermutes automatically. The explicit-ppermute
formulation of the same exchange lives in parallel/halo.py.

The shard axis must not host an NEE boundary plane (the plane would
otherwise be split across shard boundaries' halo logic): cavity /
poiseuille / bifurcation have BCs on y -> shard x; coronary has BCs on x
and z -> shard y; curved vessel has BCs on x and y -> shard z.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def free_axis(spec) -> int:
    """First lattice axis with no boundary plane on it."""
    used = {bc.axis for bc in spec.boundaries}
    for a in range(3):
        if a not in used:
            return a
    raise ValueError("no boundary-free axis to shard over")


def lattice_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    return Mesh(np.asarray(devs[:n]), axis_names=("d",))


def lattice_sharding(
    n_devices: Optional[int] = None,
    axis: int = 0,
    mesh: Optional[Mesh] = None,
    leading: int = 1,
) -> NamedSharding:
    """Sharding for a (Q, nx, ny, nz)-like array split along lattice `axis`.

    `leading` is the number of leading non-lattice dims (1 for f's Q dim,
    0 for a plain (nx,ny,nz) field).
    """
    mesh = lattice_mesh(n_devices) if mesh is None else mesh
    spec = [None] * (leading + 3)
    spec[leading + axis] = "d"
    return NamedSharding(mesh, P(*spec))


def shard_case(case, mesh: Mesh, axis: int):
    """Lay out a compiled case (a pytree, engine/compile.register_case)
    on the mesh: every per-cell array — trailing dims equal to the
    lattice shape — is split along lattice `axis` like f; the rest (BC
    planes, series, small tables) is replicated. The GSPMD runner, the
    coupled and thermal transports and the shard_map halo step all use
    this one layout."""
    shape = tuple(case.shape)

    def put(a):
        if a.ndim >= 3 and tuple(a.shape[-3:]) == shape:
            s = lattice_sharding(axis=axis, mesh=mesh, leading=a.ndim - 3)
        else:
            s = NamedSharding(mesh, P())
        return jax.device_put(a, s)

    return jax.tree_util.tree_map(put, case)


__all__ = ["free_axis", "lattice_mesh", "lattice_sharding", "shard_case"]
