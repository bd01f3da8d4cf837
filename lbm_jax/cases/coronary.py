"""Coronary artery tree (reference: coronary_cfd/coronary.cu).

291 x 291 x 372 grid, one velocity+pressure inlet at x=3 (rho* = 1 AND
u* = 0.1745/C_U, coronary.cu:716-792), main outlet at x=272 (rho
extrapolated, u* = 0.1/C_U, :795-867), three sub-outlets at z=185/191/204
labeled 5/6/7 (rho extrapolated, u* = 0.02/C_U along +z, applied to the
-z directions, :870-942). 300000 steps, u^2-windowed residual every 5000.

The required ./geo.txt is NOT shipped in the reference mirror
(coronary.cu:45, SURVEY.md section 2.1), so `build()` also offers a
synthetic branched-tree generator with the same BC structure for testing
and benchmarking at arbitrary scale.
"""

from __future__ import annotations

import numpy as np

from lbm_jax.cases import register
from lbm_jax.core.lattice import D3Q19
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.geometry.io import load_geo
from lbm_jax.geometry.mask import (
    CellType,
    end_plane_min_label,
    erode_label,
    ghost_dilate,
)

REAL_SHAPE = (291, 291, 372)
C_U = 2.74909090909091
CH = 6.1111e-05


def build_labels(
    flag: np.ndarray,
    inlet_x: int,
    outlet_x: int,
    subs: list[tuple[int, tuple[slice, slice] | None]],
) -> np.ndarray:
    """coronary.cu:31-274 label derivation: full-interior 3-pass erosion,
    in-plane min passes for inlet (1), main outlet (2) and sub-outlets
    (4/5/6 -> labels 5/6/7), wall-sourced ghost dilation."""
    geo = erode_label(flag, passes=3)
    geo = end_plane_min_label(geo, flag, axis=0, coord=inlet_x, passes=1)
    geo = end_plane_min_label(geo, flag, axis=0, coord=outlet_x, passes=2)
    for k, (z, window) in enumerate(subs):
        geo = end_plane_min_label(
            geo, flag, axis=2, coord=z, passes=4 + k, window=window
        )
    return ghost_dilate(geo, source_labels=(CellType.WALL,))


def synthetic_tree_flag(
    nx: int, ny: int, nz: int, radius: int, inlet_x: int, outlet_x: int,
    branch_xs: list[int], branch_z_caps: list[int],
    stenosis=None,
) -> np.ndarray:
    """A branched-tube occupancy grid with the coronary BC topology: a
    main tube along x (capped at inlet_x/outlet_x) and side branches along
    +z (capped at their z plane).

    stenosis: optional (severity, x_center, length) — a smooth
    axisymmetric cosine constriction of the MAIN tube,
    r(x) = radius (1 - severity cos^2(pi (x - xc)/length)) for
    |x - xc| < length/2 (the standard smooth-stenosis benchmark
    shape); severity is the fractional DIAMETER reduction at the
    throat (0.5 = a 50% stenosis). The FFR diagnostic
    (engine/diagnostics.ffr) exists to grade exactly this."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    x = np.arange(nx)[:, None, None]
    r_main = np.full((nx, 1, 1), float(radius))
    if stenosis is not None:
        sev, xc, length = (float(v) for v in stenosis)
        assert 0.0 < sev < 1.0 and length > 0
        xs = np.arange(nx, dtype=np.float64)
        inside = np.abs(xs - xc) < length / 2.0
        shrink = 1.0 - sev * np.cos(np.pi * (xs - xc) / length) ** 2
        r_main = np.where(inside, radius * shrink, radius)[:, None, None]
    main = ((y - cy) ** 2 + (z - cz) ** 2 <= r_main**2) & (x >= inlet_x) & (
        x <= outlet_x
    )
    flag = main
    for bx, zcap in zip(branch_xs, branch_z_caps):
        br = ((x - bx) ** 2 + (y - cy) ** 2 <= radius**2) & (z >= cz) & (z <= zcap)
        flag = flag | br
    flag = flag.astype(np.int32)
    flag[0], flag[-1] = 0, 0
    flag[:, 0], flag[:, -1] = 0, 0
    flag[:, :, 0], flag[:, :, -1] = 0, 0
    return flag


def synthetic_tree_sdf(
    nx: int, ny: int, nz: int, radius: float,
    branch_xs: list[int],
) -> np.ndarray:
    """Exact signed distance to the branched-tube UNION surface (positive
    inside): max over the main tube's and each branch's infinite-cylinder
    SDF. End caps are BC planes (inlet/outlet/sub-outlets), not walls, so
    they are handled by labels, not by the SDF — the zero level set of
    the max is exactly the lateral union surface Bouzidi needs."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny, dtype=np.float64)[None, :, None]
    z = np.arange(nz, dtype=np.float64)[None, None, :]
    x = np.arange(nx, dtype=np.float64)[:, None, None]
    sdf = radius - np.sqrt((y - cy) ** 2 + (z - cz) ** 2)
    sdf = np.broadcast_to(sdf, (nx, ny, nz)).copy()
    for bx in branch_xs:
        br = radius - np.sqrt((x - bx) ** 2 + (y - cy) ** 2)
        # the branch exists only above the main axis plane z >= cz
        # (synthetic_tree_flag's z-range); below it would carve a
        # phantom tube through the main lumen's mirror side
        np.maximum(sdf, np.where(z >= cz, br, -np.inf), out=sdf)
    return sdf.astype(np.float32)


def curved_tree_mask(
    nx: int, ny: int, nz: int, radius: float, inlet_x: int, outlet_x: int,
    branch_xs: list[int], branch_z_caps: list[int], sdf: np.ndarray,
) -> np.ndarray:
    """Curved-wall (Bouzidi) variant of the synthetic-tree mask: FLUID
    where the analytic SDF is positive (within the axis caps), WALL =
    the first solid shell on the LATERAL surface only (sdf <= 0 — cells
    beyond the end caps stay DEAD so the BC planes own those links),
    then the same ghost dilation as the voxel route. Unlike
    build_labels' erosion (whose WALL cells sit INSIDE the analytic
    surface, reference parity), this places the voxel wall exactly
    around the sdf = 0 crossing so link_q measures true fractions."""
    cy, cz = (ny - 1) / 2.0, nz // 4
    y = np.arange(ny)[None, :, None]
    z = np.arange(nz)[None, None, :]
    x = np.arange(nx)[:, None, None]
    in_any = np.broadcast_to((x >= inlet_x) & (x <= outlet_x),
                             (nx, ny, nz)).copy()
    for bx, zcap in zip(branch_xs, branch_z_caps):
        rbr = np.sqrt((x - bx) ** 2 + (y - cy) ** 2)
        in_any |= (rbr <= radius) & (z >= cz) & (z <= zcap)
    fluid = (sdf > 0.0) & in_any
    near = np.zeros_like(fluid)
    for i in range(1, 19):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        near |= np.roll(fluid, shift=(ex, ey, ez), axis=(0, 1, 2))
    wall = near & ~fluid & (sdf <= 0.0)
    mask = np.zeros((nx, ny, nz), np.int32)
    mask[wall] = CellType.WALL
    mask[fluid] = CellType.FLUID
    return ghost_dilate(mask, source_labels=(CellType.WALL,))


def _relabel_plane(mask, axis, coord, label, window=None):
    """Set FLUID cells on the given plane (optionally windowed in the
    two lateral axes) to `label` — the curved variant's equivalent of
    end_plane_min_label (which needs the erosion-labeled geo)."""
    idx: list = [slice(None)] * 3
    idx[axis] = coord
    if window is not None:
        lat = [a for a in range(3) if a != axis]
        idx[lat[0]], idx[lat[1]] = window
    plane = mask[tuple(idx)]
    plane[plane == CellType.FLUID] = label
    mask[tuple(idx)] = plane
    return mask


def _boundaries(inlet_x, outlet_x, sub_planes, sub_labels,
                windkessel=None, pulsatile=None,
                shape=None, inlet_scale: float = 1.0) -> list[PlaneBC]:
    """windkessel: None reproduces the reference's prescribed-velocity
    outlets (coronary.cu:795-942); a list of four (Rp, C, Rd) lattice
    tuples — [main outlet, sub-outlet 5, 6, 7] — replaces every outlet
    with a pressure outlet coupled to its own RCR termination
    (spec.PlaneBC.windkessel), so the flow SPLIT emerges from the
    downstream resistances instead of hard-coded outlet speeds — the
    clinical truncated-vasculature configuration."""
    u_in = inlet_scale * 0.1745 / C_U
    if pulsatile is not None:
        # systole/diastole-gated plug inlet: the reference's steady
        # u* = 0.1745 m/s (coronary.cu:716-792) scaled by the periodic
        # waveform of cases/curved_vessel.pulse_waveform — the
        # time-resolved regime of engine/scalar.CoupledTransport
        from lbm_jax.cases.curved_vessel import pulse_waveform

        nphase, period_steps = (int(v) for v in pulsatile)
        wave = pulse_waveform(nphase)
        A, B = shape[1], shape[2]
        series = np.zeros((nphase, 3, A, B), np.float32)
        series[:, 0] = (wave * u_in)[:, None, None]
        inlet = PlaneBC(
            mask_value=int(CellType.INLET), axis=0, coord=inlet_x,
            normal=+1, rho_mode="fixed", rho_value=1.0,
            u_mode="series", u_series=series,
            u_series_stride=max(1, period_steps // nphase),
        )
    else:
        # coronary.cu:716-792: rho* = 1 AND u* prescribed at the inlet.
        inlet = PlaneBC(
            mask_value=int(CellType.INLET), axis=0, coord=inlet_x,
            normal=+1, rho_mode="fixed", rho_value=1.0, u_mode="fixed",
            u_value=(u_in, 0.0, 0.0),
        )
    bcs = [inlet]
    if windkessel is not None:
        wk = [tuple(float(v) for v in w) for w in windkessel]
        assert len(wk) == 1 + len(sub_planes), (
            "coronary windkessel wants one (Rp, C, Rd) per outlet: "
            "[main, sub5, sub6, sub7]"
        )
        bcs.append(PlaneBC(
            mask_value=int(CellType.OUTLET), axis=0, coord=outlet_x,
            normal=-1, rho_mode="fixed", rho_value=1.0,
            u_mode="extrapolate", windkessel=wk[0],
        ))
        for k, (label, z) in enumerate(zip(sub_labels, sub_planes)):
            bcs.append(PlaneBC(
                mask_value=label, axis=2, coord=z, normal=-1,
                rho_mode="fixed", rho_value=1.0, u_mode="extrapolate",
                windkessel=wk[1 + k],
            ))
        return bcs
    # coronary.cu:795-867: rho extrapolated, u* = 0.1/C_U.
    bcs.append(PlaneBC(
        mask_value=int(CellType.OUTLET), axis=0, coord=outlet_x, normal=-1,
        rho_mode="extrapolate", u_mode="fixed",
        u_value=(0.1 / C_U, 0.0, 0.0),
    ))
    for label, z in zip(sub_labels, sub_planes):
        # coronary.cu:870-942: -z directions, u* = +0.02/C_U along z.
        bcs.append(
            PlaneBC(
                mask_value=label, axis=2, coord=z, normal=-1,
                rho_mode="extrapolate", u_mode="fixed",
                u_value=(0.0, 0.0, 0.02 / C_U),
            )
        )
    return bcs


@register("coronary")
def build(
    geo_path: str | None = None,
    tau: float = 0.55,
    max_steps: int = 300000,
    time_save: int = 5000,
    tol: float = 1e-6,  # 0 disables early stop: the reference runs the
    # full 300k steps unconditionally (coronary.cu:1055-1163)
    # synthetic-geometry knobs (used when geo_path is None):
    shape: tuple[int, int, int] = (128, 64, 96),
    radius: int = 10,
    curved: bool = False,
    collision: str = "bgk",
    magic_lambda: float = 0.1875,
    mrt_rates=None,
    smagorinsky_cs=None,
    rheology=None,
    force=None,
    windkessel=None,  # [main, sub5, sub6, sub7] (Rp, C, Rd) lattice
    # tuples: RCR-terminated pressure outlets instead of the
    # reference's prescribed outlet velocities (see _boundaries)
    pulsatile=None,  # (nphase, period_steps): systole/diastole-gated
    # series inlet (pulse_waveform) instead of the steady plug — the
    # time-resolved clinical configuration (pairs with windkessel=)
    inlet_scale: float = 1.0,  # LATTICE inlet speed multiplier (raises
    # lattice Ma directly — prefer hyperemia= for physiological rates)
    hyperemia: float = 1.0,  # physical flow multiplier at FIXED lattice
    # speed: rescales the unit system (C_U *= h => physical inlet speed
    # h * 0.1745 m/s at the same u_lat) and the relaxation time
    # (tau -> 1/2 + (tau - 1/2)/h keeps the physical viscosity), so
    # hyperemic FFR runs 3-5x resting flow without raising lattice Ma
    # anywhere — the stenosis throat is the Ma-limiting site and scales
    # ~(R/r)^2 off the UNSCALED u_lat. Pair with collision='trt' for
    # stability at the reduced tau.
    stenosis: float | None = None,  # fractional diameter reduction of
    # a smooth cosine constriction on the main tube proximal segment
    # (synthetic_tree_flag; voxel synthetic route only) — the lesion
    # the FFR diagnostic grades
) -> CaseSpec:
    assert hyperemia >= 1.0, "hyperemia is a flow MULTIPLIER (>= 1)"
    units = UnitSystem(CH=CH, C_U=C_U * hyperemia, C_rho=1060.0)
    if hyperemia != 1.0:
        tau = 0.5 + (tau - 0.5) / hyperemia
        assert tau > 0.5005, (
            f"hyperemia={hyperemia} drives tau to {tau:.5f} — too "
            "stiff; raise the base tau or lower the hyperemic factor")
    wall_sdf = None
    if stenosis is not None:
        assert geo_path is None and not curved, (
            "stenosis= is a synthetic voxel-route knob (file geometries "
            "carry their own lesions; the curved SDF has no constriction)"
        )
    if geo_path is not None:
        assert not curved, (
            "curved=True (Bouzidi walls) needs the analytic synthetic "
            "tree; file geometries have no SDF"
        )
        nx, ny, nz = REAL_SHAPE
        flag = load_geo(geo_path, REAL_SHAPE, order="yxz")
        inlet_x, outlet_x = 3, 272
        subs = [
            (185, (slice(217, 237), slice(113, 138))),  # coronary.cu:101-113
            (191, (slice(160, 206), slice(159, 200))),  # :115-127
            (204, None),                                 # :129-141
        ]
        mask = build_labels(flag, inlet_x, outlet_x, subs)
        shape = REAL_SHAPE
    else:
        nx, ny, nz = shape
        inlet_x, outlet_x = 3, nx - 4
        bw = radius + 2
        branch_xs = [nx // 3, nx // 2, 2 * nx // 3]
        caps = [nz - 3 * bw, nz - 2 * bw, nz - bw]
        cy = (ny - 1) // 2
        subs = [
            (caps[k], (slice(branch_xs[k] - bw, branch_xs[k] + bw),
                       slice(cy - bw, cy + bw)))
            for k in range(3)
        ]
        if curved:
            # Bouzidi curved-wall variant: mask + exact union SDF (the
            # voxel route's erosion WALL sits inside the analytic
            # surface; see curved_tree_mask). Off-grid radius so no
            # link is accidentally half-way.
            wall_sdf = synthetic_tree_sdf(nx, ny, nz, radius - 0.28,
                                          branch_xs)
            mask = curved_tree_mask(nx, ny, nz, radius - 0.28, inlet_x,
                                    outlet_x, branch_xs, caps, wall_sdf)
            mask = _relabel_plane(mask, 0, inlet_x, CellType.INLET)
            mask = _relabel_plane(mask, 0, outlet_x, CellType.OUTLET)
            for k, (zc, window) in enumerate(subs):
                mask = _relabel_plane(mask, 2, zc, 5 + k, window)
        else:
            sten = None
            if stenosis is not None:
                # proximal main-tube lesion: midway between the inlet
                # and the first branch, 3 diameters long
                sten = (float(stenosis),
                        (inlet_x + branch_xs[0]) / 2.0,
                        3.0 * radius)
            flag = synthetic_tree_flag(
                nx, ny, nz, radius, inlet_x, outlet_x, branch_xs, caps,
                stenosis=sten,
            )
            mask = build_labels(flag, inlet_x, outlet_x, subs)

    sub_planes = [s[0] for s in subs]
    bcs = _boundaries(inlet_x, outlet_x, sub_planes, sub_labels=(5, 6, 7),
                      windkessel=windkessel, pulsatile=pulsatile,
                      shape=tuple(shape), inlet_scale=inlet_scale)
    u0 = np.zeros((3,) + tuple(shape), np.float32)
    # coronary.cu:297-309: prescribed BC speeds in the init macro fields.
    u0[0][mask == CellType.INLET] = inlet_scale * 0.1745 / C_U
    if windkessel is None:
        u0[0][mask == CellType.OUTLET] = 0.1 / C_U
        for label in (5, 6, 7):
            u0[2][mask == label] = 0.02 / C_U
    return CaseSpec(
        collision=collision,
        magic_lambda=magic_lambda,
        mrt_rates=mrt_rates,
        smagorinsky_cs=smagorinsky_cs,
        rheology=rheology,
        force=force,
        name="coronary",
        shape=tuple(shape),
        tau=tau,
        units=units,
        mask=mask,
        wall_sdf=wall_sdf,
        boundaries=bcs,
        u0=u0,
        max_steps=max_steps,
        time_save=time_save,
        tol=tol,
        stag_max=10**9,
        residual_flavor="usq",
        vtk_crops=(1, 2, 1),
        vtk_density=True,
        usq_includes_outlet_labels=False,
    )
