"""Circular pipe (beyond-reference case): curved-wall accuracy anchor.

A straight circular pipe along z (fully periodic — the same BC-free
layout as gravity_channel), driven by a constant body force. The steady
state is Hagen-Poiseuille flow u_z(r) = F/(4 rho nu) (R^2 - r^2), the
canonical analytic anchor for CURVED walls: the voxel staircase the
reference uses everywhere (its vessel trees are voxelized surfaces,
coronary.cu geometry path) makes the wall-position error first-order,
while Bouzidi interpolated bounce-back (CaseSpec.wall_sdf,
core/bouzidi.py) restores second order. The default center sits off
the grid points so no wall link is accidentally half-way.

curved=True supplies the exact signed distance field R - r; curved=False
runs the same geometry with plain staircase bounce-back — the pair is
the measurement in tests/test_bouzidi.py.
"""

from __future__ import annotations

import numpy as np

from lbm_jax.cases import register
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType
from lbm_jax.core.lattice import D3Q19


def pipe_sdf(n: int, radius: float, center: tuple[float, float]):
    """(n, n) signed distance to the pipe surface, positive inside."""
    x = np.arange(n, dtype=np.float64)
    dx = x[:, None] - center[0]
    dy = x[None, :] - center[1]
    return radius - np.sqrt(dx * dx + dy * dy)


@register("pipe")
def build(
    n: int = 36,
    nz: int = 8,
    radius: float | None = None,
    center: tuple[float, float] | None = None,
    tau: float = 0.8,
    fz: float = 2e-6,
    curved: bool = True,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    CH: float = 0.0000655737,
    C_U: float = 2.4705,
    max_steps: int = 20000,
    time_save: int = 500,
) -> CaseSpec:
    units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
    if radius is None:
        radius = 0.5 * n - 4.3
    if center is None:
        # off-lattice center: exercises every fractional q
        center = ((n - 1) / 2 + 0.23, (n - 1) / 2 + 0.38)
    assert radius + max(abs(center[0] - (n - 1) / 2),
                        abs(center[1] - (n - 1) / 2)) < n / 2 - 2, \
        "pipe must leave >=2 non-fluid layers on x/y box faces"
    sdf2 = pipe_sdf(n, radius, center)                  # (n, n)
    fluid2 = sdf2 > 0.0
    # walls: first solid shell around the fluid (rest stays DEAD so the
    # sparse backend compacts away the corners)
    near = np.zeros_like(fluid2)
    for i in range(1, 19):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        if ez != 0 and ex == 0 and ey == 0:
            continue
        near |= np.roll(fluid2, shift=(ex, ey), axis=(0, 1))
    wall2 = near & ~fluid2
    mask2 = np.zeros((n, n), np.int32)
    mask2[wall2] = CellType.WALL
    mask2[fluid2] = CellType.FLUID
    mask = np.repeat(mask2[:, :, None], nz, axis=2)
    wall_sdf = (
        np.repeat(sdf2.astype(np.float32)[:, :, None], nz, axis=2)
        if curved else None
    )
    return CaseSpec(
        name="pipe",
        shape=(n, n, nz),
        tau=tau,
        units=units,
        mask=mask,
        boundaries=[],
        force=(0.0, 0.0, fz),
        wall_sdf=wall_sdf,
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        max_steps=max_steps,
        time_save=time_save,
        tol=1e-6,
        stag_max=50,
        residual_flavor="velsum",
        vtk_crops=(2, 2, 0),
    )
