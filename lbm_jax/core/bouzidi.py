"""Bouzidi linear interpolated bounce-back for curved walls.

The reference (like this framework's default) realizes walls as
half-way bounce-back on the voxel staircase — first-order accurate in
the wall position, which is exactly the error that dominates WSS and
velocity profiles in curved vessels (the reference's own domain:
coronary.cu builds its tree from voxelized surfaces and accepts the
staircase). Bouzidi/Firdaouss/Lallemand (2001) restores second-order
accuracy with a LINEAR interpolation along each lattice link using the
fractional distance q in (0, 1] from the fluid node to the true wall
surface:

  for fluid node x with wall neighbour along i (pull direction
  j = opp(i)), post-collision populations f*:
    q < 1/2 : f_j(x, t+1) = 2q f*_i(x) + (1 - 2q) f*_i(x - e_i)
    q >= 1/2: f_j(x, t+1) = 1/(2q) f*_i(x) + (1 - 1/(2q)) f*_j(x)
  q = 1/2 reduces exactly to half-way bounce-back (both branches give
  f*_i(x)).

Both branches are LOCAL in the fused pull pass of engine/step.py:
f*_i(x) is the value plain bounce-back already uses, f*_j(x) is the
cell's own pdf, and f*_i(x - e_i) = f*_i(x + e_j) is direction i's
ordinary direct pull (computed anyway; XLA CSEs the duplicate roll).
So curved walls cost three multiplies per wall link and no extra
passes — the same fusion argument as the plain step.

q is sampled from a signed distance field at cell centers
(CaseSpec.wall_sdf, positive in fluid): along the link the surface sits
at the linear zero crossing, q = sdf(x) / (sdf(x) - sdf(x - e_j)).
When the second fluid node x + e_j needed by the q < 1/2 branch is not
FLUID (thin gaps, one-cell channels), that link falls back to q = 1/2
(plain half-way BB) — the standard degeneracy handling.

Supported on the dense XLA backend (incl. GSPMD mesh sharding — the
coefficients are plain per-direction arrays, so the SPMD partitioner
shards them with the state) and the sparse gather backend (q compacts
to live cells).
"""

from __future__ import annotations

import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.geometry.mask import CellType

_E = D3Q19.E


def link_q(mask: np.ndarray, sdf: np.ndarray,
           q_min: float = 1e-3) -> np.ndarray:
    """(19, nx, ny, nz) float32 per-pull-direction fractional wall
    distances, with every inapplicable/fallback entry folded to 1/2.

    Entry [j, x] is consumed only where the pull source x - e_j is a
    WALL cell and x is FLUID; everywhere else it is 1/2 so the Bouzidi
    coefficients degenerate to plain bounce-back and the select in
    engine/step.streamed stays a no-op there.
    """
    mask = np.asarray(mask)
    sdf = np.asarray(sdf, np.float64)
    assert sdf.shape == mask.shape, "wall_sdf must match the mask shape"
    wall = mask == CellType.WALL
    fluid = mask == CellType.FLUID
    q = np.full((19,) + mask.shape, 0.5, np.float32)
    for j in range(1, 19):
        ej = tuple(int(v) for v in _E[j])
        nej = tuple(-int(v) for v in _E[j])
        # pull source x - e_j is a wall (mirrors compile.nbr_wall)
        link = np.roll(wall, shift=ej, axis=(0, 1, 2)) & fluid
        phi_s = np.roll(sdf, shift=ej, axis=(0, 1, 2))
        denom = sdf - phi_s
        qj = np.where(np.abs(denom) > 1e-12, sdf / np.where(denom == 0, 1.0, denom), 0.5)
        # Inconsistent samples (label says wall, sdf says otherwise)
        # clip to the node positions: q in [q_min, 1].
        qj = np.clip(qj, q_min, 1.0)
        # The q < 1/2 branch interpolates with the SECOND node x + e_j;
        # if that is not fluid, degrade this link to half-way BB.
        far_fluid = np.roll(fluid, shift=nej, axis=(0, 1, 2))
        qj = np.where((qj < 0.5) & ~far_fluid, 0.5, qj)
        q[j] = np.where(link, qj, 0.5).astype(np.float32)
    return q


def bouzidi_coeffs(q):
    """The three link coefficients from q (array of any backend/shape):
      value = a * f_i(x)  +  b_up * f_i(x + e_j)  +  b_loc * f_j(x)
    with i = opp(j). At q = 1/2: (1, 0, 0) — plain bounce-back."""
    lo = q < 0.5
    inv2q = 0.5 / q
    a = np.where(lo, 2.0 * q, inv2q) if isinstance(q, np.ndarray) else None
    if a is not None:
        b_up = np.where(lo, 1.0 - 2.0 * q, 0.0)
        b_loc = np.where(lo, 0.0, 1.0 - inv2q)
        return a, b_up, b_loc
    import jax.numpy as jnp

    a = jnp.where(lo, 2.0 * q, inv2q)
    b_up = jnp.where(lo, 1.0 - 2.0 * q, 0.0)
    b_loc = jnp.where(lo, 0.0, 1.0 - inv2q)
    return a, b_up, b_loc


__all__ = ["link_q", "bouzidi_coeffs"]
