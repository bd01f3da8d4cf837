"""Cell-mask derivation: erosion labeling, end-plane relabel, ghost dilation,
sparse compaction.

Reimplements (vectorized, NumPy on host — this is offline preprocessing)
the semantics of the reference's `geo_pre()` / `index_transform()`:
  - Poiseulle_flow/Poiseulle.cu:52-271 (analytic pipe, min-erosion labels,
    end-plane min passes, 18-neighbor ghost dilation, compaction)
  - bifurcation/bifurcation.cu:36-253 (file geometry, copy-style end relabel)
  - coronary_cfd/coronary.cu:31-274 (windowed sub-outlet relabel)

The general 6-valued scheme (README.md:9-14):
  not-used 0, wall 1, inlet 2, outlet 3, fluid 4, ghost -1;
extra outlet labels (5, 6, 7, ...) are allowed (coronary.cu:870).
"""

from __future__ import annotations

import enum

import numpy as np

from lbm_jax.core.lattice import D3Q19


class CellType(enum.IntEnum):
    GHOST = -1
    DEAD = 0
    WALL = 1
    INLET = 2
    OUTLET = 3
    FLUID = 4
    # Extra boundary labels (coronary sub-outlets) use values >= 5, so
    # the positive space is open-ended and case-owned. MOVING
    # (beyond-reference) therefore lives in the negative space next to
    # GHOST: a no-slip wall translating at CaseSpec.wall_velocity,
    # realized as half-way bounce-back with the Ladd momentum term
    # (see engine/step.streamed). Negative also keeps it out of the
    # usq-residual's `label > 4` BC-offset convention.
    MOVING = -2


def _min6(flag: np.ndarray) -> np.ndarray:
    """Min over the 6 face neighbors, valid on the interior (1..N-2).

    Matches Poiseulle.cu:99-103 exactly (no wraparound: we only ever
    evaluate this on interior cells, like the reference's loop bounds).
    """
    m = np.minimum(flag[2:, 1:-1, 1:-1], flag[:-2, 1:-1, 1:-1])
    m = np.minimum(m, np.minimum(flag[1:-1, 2:, 1:-1], flag[1:-1, :-2, 1:-1]))
    m = np.minimum(m, np.minimum(flag[1:-1, 1:-1, 2:], flag[1:-1, 1:-1, :-2]))
    return m


def erode_label(
    flag: np.ndarray,
    geo: np.ndarray | None = None,
    passes: int = 3,
    region: tuple[slice, slice, slice] | None = None,
) -> np.ndarray:
    """Bulk erosion labeling: geo[cell] += passes * min(6-neighbors of flag).

    `flag` is the binary occupancy; `geo` starts as a copy of flag unless
    given. The min is always computed on the ORIGINAL binary flag (the
    reference never updates `flag` between passes — Poiseulle.cu:94-108),
    so `passes` passes just add `passes * min6`. Interior cells (all six
    neighbors occupied) become 1 + passes = 4 (fluid); surface cells stay
    1 (wall).

    `region` restricts the updated cells (slices in x, y, z), defaulting
    to the full interior 1..N-2 on every axis (coronary.cu:59-73). The
    Poiseuille/bifurcation variant restricts y to 2..NY-3
    (Poiseulle.cu:95-97).
    """
    flag = np.asarray(flag)
    geo = flag.astype(np.int32).copy() if geo is None else geo
    nx, ny, nz = flag.shape
    if region is None:
        region = (slice(1, nx - 1), slice(1, ny - 1), slice(1, nz - 1))
    m6 = _min6(flag.astype(np.int32))  # indexed from (1,1,1)
    sx, sy, sz = region
    sub = (
        slice(sx.start - 1, sx.stop - 1),
        slice(sy.start - 1, sy.stop - 1),
        slice(sz.start - 1, sz.stop - 1),
    )
    geo[sx, sy, sz] += passes * m6[sub]
    return geo


def end_plane_min_label(
    geo: np.ndarray,
    flag: np.ndarray,
    axis: int,
    coord: int,
    passes: int,
    window: tuple[slice, slice] | None = None,
) -> np.ndarray:
    """End-plane relabel via in-plane 4-neighbor min passes.

    geo[plane cell] += passes * min(4 in-plane neighbors of flag).
    With the plane wall-capped (so the bulk erosion left it at 1), the
    interior of the opening becomes 1 + passes: passes=1 -> inlet 2
    (Poiseulle.cu:110-120), passes=2 -> outlet 3 (:122-134), passes=4/5/6
    -> coronary sub-outlets 5/6/7 (coronary.cu:101-141).

    `window` optionally restricts the two lateral axes (coronary's
    sub-outlet windows); default is the full lateral interior 1..N-2.
    """
    lat_axes = [a for a in range(3) if a != axis]
    flag = np.asarray(flag).astype(np.int32)
    plane_flag = np.take(flag, coord, axis=axis)  # (A, B) lateral
    a_n, b_n = plane_flag.shape
    if window is None:
        window = (slice(1, a_n - 1), slice(1, b_n - 1))
    wa, wb = window
    m = np.minimum(plane_flag[wa.start + 1 : wa.stop + 1, wb],
                   plane_flag[wa.start - 1 : wa.stop - 1, wb])
    m = np.minimum(m, plane_flag[wa, wb.start + 1 : wb.stop + 1])
    m = np.minimum(m, plane_flag[wa, wb.start - 1 : wb.stop - 1])
    idx: list = [slice(None)] * 3
    idx[axis] = coord
    idx[lat_axes[0]] = wa
    idx[lat_axes[1]] = wb
    geo[tuple(idx)] += passes * m
    return geo


def end_plane_copy_label(
    geo: np.ndarray, axis: int, coord: int, ref_coord: int, target: int
) -> np.ndarray:
    """Bifurcation-style end relabel (bifurcation.cu:93-119).

    On the plane `coord`, looking at the already-labeled plane `ref_coord`
    one cell inward: cells become 0, except wall where the inward neighbor
    is wall (1) and `target` (2 inlet / 3 outlet) where it is fluid (4).
    Restricted to the lateral interior 1..N-2 like the reference loops.
    """
    lat = [a for a in range(3) if a != axis]
    idx: list = [slice(None)] * 3
    idx[axis] = coord
    idx[lat[0]] = slice(1, geo.shape[lat[0]] - 1)
    idx[lat[1]] = slice(1, geo.shape[lat[1]] - 1)
    ridx = list(idx)
    ridx[axis] = ref_coord
    ref = geo[tuple(ridx)]
    out = np.zeros_like(ref)
    out[ref == CellType.WALL] = CellType.WALL
    out[ref == CellType.FLUID] = target
    geo[tuple(idx)] = out
    return geo


def ghost_dilate(geo: np.ndarray, source_labels=(CellType.WALL,)) -> np.ndarray:
    """Mark any 18-neighbor of a source-labeled interior cell that is DEAD
    as GHOST (-1).

    Poiseuille dilates from {wall, inlet, outlet} (Poiseulle.cu:138-254);
    bifurcation/coronary from wall only (bifurcation.cu:123-239). Only
    source cells in the interior box 1..N-2 emit (the reference's scan
    bounds), so shifted writes never leave the grid.
    """
    src = np.isin(geo, np.asarray(source_labels, dtype=geo.dtype))
    interior = np.zeros_like(src)
    interior[1:-1, 1:-1, 1:-1] = src[1:-1, 1:-1, 1:-1]
    marked = np.zeros_like(src)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = D3Q19.E[i]
        marked |= np.roll(interior, shift=(ex, ey, ez), axis=(0, 1, 2))
    geo = geo.copy()
    geo[(geo == CellType.DEAD) & marked] = CellType.GHOST
    return geo


def compact_index(geo: np.ndarray) -> tuple[np.ndarray, int]:
    """Sparse node compaction (Poiseulle.cu:257-271).

    Returns (index, nlattice): index[cell] = dense id for non-DEAD cells
    in z-major / x-fastest order (the reference's z,y,x loop with x inner),
    -1 for DEAD cells; nlattice = live cell count.
    """
    # z outer, y middle, x inner == C-order over the transposed (z, y, x)
    # view; materialize it once so ravel/cumsum run on contiguous memory
    # (the strided version cost ~19 s on a 16M-cell grid).
    live_t = np.ascontiguousarray(np.transpose(geo, (2, 1, 0))) != CellType.DEAD
    flat = live_t.ravel()
    ids = np.cumsum(flat, dtype=np.int64) - 1
    idx_t = np.where(flat, ids, np.int64(-1)).reshape(live_t.shape)
    return np.transpose(idx_t, (2, 1, 0)), int(flat.sum())


__all__ = [
    "CellType",
    "erode_label",
    "end_plane_min_label",
    "end_plane_copy_label",
    "ghost_dilate",
    "compact_index",
]
