"""Mask-derivation tests, including a direct (loop-style) cross-check of the
vectorized pipeline against the reference geo_pre semantics on the shipped
bifurcation geometry (SURVEY.md section 7 step 2)."""

import numpy as np
import pytest

from lbm_jax.geometry.io import load_bc, load_geo
from lbm_jax.geometry.mask import (
    CellType,
    compact_index,
    end_plane_copy_label,
    erode_label,
    ghost_dilate,
)
from lbm_jax.geometry.shapes import cavity_mask, pipe_mask

BIF_SHAPE = (64, 83, 32)


def bifurcation_labels(flag: np.ndarray) -> np.ndarray:
    """Vectorized equivalent of bifurcation.cu:36-239 (sans compaction)."""
    nx, ny, nz = flag.shape
    geo = flag.astype(np.int32).copy()
    geo[1 : nx - 1, 0, 1 : nz - 1] = 0
    geo[1 : nx - 1, ny - 1, 1 : nz - 1] = 0
    geo = erode_label(
        flag, geo=geo, passes=3,
        region=(slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1)),
    )
    geo = end_plane_copy_label(geo, axis=1, coord=1, ref_coord=2, target=2)
    geo = end_plane_copy_label(geo, axis=1, coord=ny - 2, ref_coord=ny - 3, target=3)
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


def _reference_geo_pre_loops(flag: np.ndarray) -> np.ndarray:
    """Direct, loop-structured transcription of the bifurcation geo_pre
    semantics (independent of the vectorized implementation under test)."""
    nx, ny, nz = flag.shape
    geo = flag.astype(np.int64).copy()
    for x in range(1, nx - 1):
        for z in range(1, nz - 1):
            geo[x, 0, z] = 0
            geo[x, ny - 1, z] = 0
    for _ in range(3):
        for x in range(1, nx - 1):
            for y in range(2, ny - 2):
                for z in range(1, nz - 1):
                    m = min(
                        flag[x + 1, y, z], flag[x - 1, y, z],
                        flag[x, y - 1, z], flag[x, y + 1, z],
                        flag[x, y, z - 1], flag[x, y, z + 1],
                    )
                    geo[x, y, z] += m
    for x in range(1, nx - 1):
        for z in range(1, nz - 1):
            ref = geo[x, 2, z]
            geo[x, 1, z] = 1 if ref == 1 else (2 if ref == 4 else 0)
    for _ in range(2):
        for x in range(1, nx - 1):
            for z in range(1, nz - 1):
                ref = geo[x, ny - 3, z]
                geo[x, ny - 2, z] = 1 if ref == 1 else (3 if ref == 4 else 0)
    from lbm_jax.core.lattice import D3Q19

    out = geo.copy()
    walls = np.argwhere(geo[1:-1, 1:-1, 1:-1] == 1) + 1
    for x, y, z in walls:
        for i in range(1, 19):
            ex, ey, ez = D3Q19.E[i]
            if geo[x + ex, y + ey, z + ez] == 0 and out[x + ex, y + ey, z + ez] == 0:
                out[x + ex, y + ey, z + ez] = -1
    return out.astype(np.int32)


@pytest.fixture(scope="module")
def bif_flag(reference_root):
    return load_geo(f"{reference_root}/bifurcation/geo.txt", BIF_SHAPE, order="xyz")


def test_bifurcation_geo_load(bif_flag):
    assert bif_flag.shape == BIF_SHAPE
    assert set(np.unique(bif_flag)) == {0, 1}


def test_bifurcation_labels_match_direct_loops(bif_flag):
    fast = bifurcation_labels(bif_flag)
    slow = _reference_geo_pre_loops(bif_flag)
    np.testing.assert_array_equal(fast, slow)


def test_bifurcation_label_histogram_golden(bif_flag):
    geo = bifurcation_labels(bif_flag)
    hist = {int(k): int(v) for k, v in zip(*np.unique(geo, return_counts=True))}
    # Golden values derived from the direct-loop transcription of
    # bifurcation.cu geo_pre on the shipped geo.txt. NLATTICE == 65,820
    # independently matches thesis section 4.8-B ("65,820 lattices").
    assert hist == {-1: 12214, 0: 104164, 1: 7648, 2: 345, 3: 306, 4: 45307}
    index, nlattice = compact_index(geo)
    assert nlattice == 65820
    assert (index >= 0).sum() == nlattice
    assert index.max() == nlattice - 1


def test_bifurcation_bc_maps(bif_flag, reference_root):
    slabs = load_bc(f"{reference_root}/bifurcation/bc.txt", 64, 32)
    assert len(slabs) == 3
    assert all(s.shape == (64, 32) for s in slabs)
    # Shipped file: slab 0 and 2 are zero; the measured inlet profile is
    # slab 1, max ~0.207 lattice units (SURVEY section 2.5).
    assert slabs[0].max() == 0.0 and slabs[2].max() == 0.0
    assert 0.2 < slabs[1].max() < 0.21
    geo = bifurcation_labels(bif_flag)
    inlet_cells = geo[:, 1, :] == CellType.INLET
    # The nonzero footprint covers the inlet opening exactly.
    assert inlet_cells.sum() == 345
    assert (slabs[1][inlet_cells] > 0).all()
    assert (slabs[1][geo[:, 81, :] == CellType.OUTLET] == 0).all()


def test_cavity_mask_structure():
    geo = cavity_mask(16, 16, 16)
    assert np.all(geo[0] == 0) and np.all(geo[:, :, 0] == 0)
    assert np.all(geo[2:-2, 2:-2, 2:-2] == CellType.FLUID)
    assert np.all(geo[2:-2, 14, 2:-2] == CellType.INLET)
    assert geo[1, 5, 5] == CellType.WALL


def test_pipe_mask_structure():
    nx = ny = nz = 32
    geo = pipe_mask(nx, ny, nz)
    c = (nx - 1) // 2
    # Pipe axis: fluid in the middle of the tube.
    assert geo[c, ny // 2, c] == CellType.FLUID
    assert geo[c, 1, c] == CellType.INLET
    assert geo[c, ny - 2, c] == CellType.OUTLET
    # Tube surface is wall; just outside is ghost or dead.
    assert (geo == CellType.WALL).sum() > 0
    assert (geo == CellType.GHOST).sum() > 0
    # Corners of the box are dead.
    assert geo[0, ny // 2, 0] == CellType.DEAD


def test_compact_index_order():
    geo = np.zeros((3, 3, 3), np.int32)
    geo[1, 1, 1] = 4
    geo[2, 1, 1] = 1
    geo[1, 2, 2] = -1
    index, n = compact_index(geo)
    assert n == 3
    # Order is z-major, then y, then x fastest (Poiseulle.cu:259-262).
    assert index[1, 1, 1] == 0 and index[2, 1, 1] == 1 and index[1, 2, 2] == 2


def test_geo_save_load_roundtrip_both_orders(tmp_path):
    rng = np.random.default_rng(5)
    flag = (rng.random((6, 5, 4)) < 0.4).astype(np.int32)
    from lbm_jax.geometry.io import save_geo

    for order in ("xyz", "yxz"):
        p = str(tmp_path / f"g_{order}.txt")
        save_geo(p, flag, order=order)
        back = load_geo(p, flag.shape, order=order)
        np.testing.assert_array_equal(back, flag)


def test_unit_system_derivation():
    from lbm_jax.core.units import UnitSystem

    # Reproduce ldc.cu:49's constants from the physical case parameters
    # (nu = 2.7e-6 m^2/s, CH = 6.55737e-5 m, tau = 0.55).
    us = UnitSystem.from_viscosity(2.7e-6, 0.0000655737, 0.55)
    assert abs(us.C_U - 2.4705) < 5e-4
    assert abs(us.C_pre - 1060.0 * us.C_U**2) < 1e-6
    assert abs(us.C_T - us.CH / us.C_U) < 1e-12
    assert abs(us.to_lattice_velocity(0.15) * us.C_U - 0.15) < 1e-9
