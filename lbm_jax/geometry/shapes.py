"""Analytic geometry generators for the built-in cases.

Reproduces the reference's analytic masks (lid cavity: ldc.cu:468-502;
circular pipe: Poiseulle.cu:52-255) and adds a curved-vessel (torus
section) generator for the pulsatile case whose code the reference does
not ship (curved vessel/README.md:1).
"""

from __future__ import annotations

import numpy as np

from lbm_jax.geometry.mask import (
    CellType,
    end_plane_min_label,
    erode_label,
    ghost_dilate,
)


def cavity_mask(nx: int, ny: int, nz: int) -> np.ndarray:
    """Lid-driven cavity (ldc.cu:468-502), in general labels.

    The reference's private scheme {ghost 0, wall 1, lid 2, fluid 3} maps
    to {DEAD 0, WALL 1, INLET 2 (the moving lid), FLUID 4}: outermost
    layer dead, next layer wall, lid plane at y = ny-2, fluid inside.
    """
    geo = np.zeros((nx, ny, nz), dtype=np.int32)
    geo[1:-1, 1:-1, 1:-1] = CellType.WALL
    geo[2:-2, 2:-2, 2:-2] = CellType.FLUID
    geo[1:-1, ny - 2, 1:-1] = CellType.INLET  # moving lid (velocity BC)
    return geo


def pipe_mask(nx: int, ny: int, nz: int) -> np.ndarray:
    """Circular pipe along y (Poiseulle.cu:52-255), general labels.

    Binary cylinder of radius (nx-1)/2 for y in 1..ny-2, 3-pass erosion
    labeling with the y-range restricted to 2..ny-3, end-plane min passes
    (1 pass -> inlet 2 at y=1; 2 passes -> outlet 3 at y=ny-2), ghost
    dilation sourced from {wall, inlet, outlet} (Poiseulle.cu:142).
    """
    cx, cz = (nx - 1) / 2.0, (nz - 1) / 2.0
    radius = (nx - 1) / 2.0
    x = np.arange(nx, dtype=np.float32)[:, None]
    z = np.arange(nz, dtype=np.float32)[None, :]
    disc = (np.sqrt((x - cx) ** 2 + (z - cz) ** 2) <= radius).astype(np.int32)
    flag = np.zeros((nx, ny, nz), dtype=np.int32)
    flag[:, 1 : ny - 1, :] = disc[:, None, :]
    geo = erode_label(
        flag, passes=3,
        region=(slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1)),
    )
    geo = end_plane_min_label(geo, flag, axis=1, coord=1, passes=1)
    geo = end_plane_min_label(geo, flag, axis=1, coord=ny - 2, passes=2)
    geo = ghost_dilate(
        geo, source_labels=(CellType.WALL, CellType.INLET, CellType.OUTLET)
    )
    return geo


def pipe_parabola(nx: int, nz: int, u_max: float) -> np.ndarray:
    """Analytic parabolic inflow profile u(r) = u_max (1 - r^2/R^2) on the
    pipe cross-section (Poiseulle.cu:301,597). Negative outside the radius
    (matching the reference's unclamped formula). Shape (nx, nz)."""
    cx, cz = (nx - 1) / 2.0, (nz - 1) / 2.0
    radius = (nx - 1) / 2.0
    x = np.arange(nx, dtype=np.float32)[:, None]
    z = np.arange(nz, dtype=np.float32)[None, :]
    r2 = (x - cx) ** 2 + (z - cz) ** 2
    return (u_max * (1.0 - r2 / radius**2)).astype(np.float32)


def curved_pipe_mask(
    nx: int, ny: int, nz: int, bend_radius: float, pipe_radius: float
) -> np.ndarray:
    """Quarter-torus curved vessel in the x-y plane, inlet plane y=1,
    outlet plane x=nx-2 (the case described in curved vessel/README.md but
    not shipped). Centerline: circle of radius `bend_radius` centered at
    (cx0, cy0) so the tube enters vertically at y=1 and exits horizontally
    at x=nx-2. Labels derived with the same erosion pipeline as the pipe.
    """
    zc = (nz - 1) / 2.0
    # Torus center: tube crosses y-axis-aligned inlet at (cx0-bend, *) and
    # x-aligned outlet at (*, cy0+bend) -- place center so both fit.
    cx0 = 1.0 + pipe_radius + bend_radius
    cy0 = 1.0 + pipe_radius + bend_radius  # symmetric quarter bend
    xs = np.arange(nx, dtype=np.float32)[:, None, None]
    ys = np.arange(ny, dtype=np.float32)[None, :, None]
    zs = np.arange(nz, dtype=np.float32)[None, None, :]
    rxy = np.sqrt((xs - cx0) ** 2 + (ys - cy0) ** 2)
    dist = np.sqrt((rxy - bend_radius) ** 2 + (zs - zc) ** 2)
    inside = dist <= pipe_radius
    # Only keep the quarter where x <= cx0 or y <= cy0 (the bend), plus
    # straight extensions to the inlet/outlet planes.
    quarter = (xs <= cx0) & (ys <= cy0)
    leg_in = (np.abs(xs - (cx0 - bend_radius)) <= pipe_radius) & (ys <= cy0)
    leg_in = leg_in & (np.sqrt((xs - (cx0 - bend_radius)) ** 2 + (zs - zc) ** 2) <= pipe_radius)
    leg_out = (np.abs(ys - (cy0 - bend_radius)) <= pipe_radius) & (xs >= cx0)
    leg_out = leg_out & (np.sqrt((ys - (cy0 - bend_radius)) ** 2 + (zs - zc) ** 2) <= pipe_radius)
    flag = ((inside & quarter) | leg_in | leg_out).astype(np.int32)
    flag[:, 0, :] = 0
    flag[:, :, 0] = flag[:, :, -1] = 0
    flag[0, :, :] = 0
    # Cap the open ends one layer inside the domain.
    flag[:, ny - 1 :, :] = 0
    flag[nx - 1 :, :, :] = 0
    geo = erode_label(flag, passes=3)
    geo = end_plane_min_label(geo, flag, axis=1, coord=1, passes=1)
    geo = end_plane_min_label(geo, flag, axis=0, coord=nx - 2, passes=2)
    geo = ghost_dilate(geo, source_labels=(CellType.WALL,))
    return geo


__all__ = ["cavity_mask", "pipe_mask", "pipe_parabola", "curved_pipe_mask"]
