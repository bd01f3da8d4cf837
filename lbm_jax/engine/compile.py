"""Compile a CaseSpec into device-ready arrays and precomputed BC data.

The key precomputations that make the runtime step a single fused pass
(see step.py):

  - `nbr_wall[i] = roll(mask == WALL, e_i)`: per-direction booleans
    marking cells whose pull-source in direction i is a wall. Streaming
    then replaces the pull with the cell's OWN opposite post-collision
    pdf — algebraically identical to the reference's two-kernel half-way
    bounce-back (wall stores reversed neighbors at Poiseulle.cu:601-746,
    fluid pulls them back next step), because the stored value
    dst[i at w] = dst[opp(i) at w + e_i] is consumed exactly by the cell
    w + e_i that donated it.

  - Per-boundary consumer-plane data: the NEE write at boundary cell b in
    direction i (e.g. bifurcation.cu:950-1021) is consumed next step only
    by the fluid cell F = b + e_i — the same cell whose post-collision
    state the formula reads. So NEE also fuses into the next step's pull,
    evaluated on the one-cell-thick consumer plane.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.core.rheology import normalize_closure
from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.geometry.mask import CellType


_W64 = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
                dtype=np.float64)


def _phi_np(u: np.ndarray, dirs: np.ndarray,
            dtype=np.float32) -> np.ndarray:
    """Host-side phi for precomputing static boundary equilibria.

    u: (3, A, B) -> (D, A, B), fp32 like the runtime path (float64 for
    the algebraic-identity proof runs).
    """
    e = D3Q19.E[dirs].astype(dtype)
    w = _W64[dirs].astype(dtype)
    u = u.astype(dtype)
    cu = np.tensordot(e, u, axes=([1], [0]))
    usq = np.sum(u * u, axis=0)
    return (w[:, None, None] * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)
            ).astype(dtype)


def register_case(cls, arrays: tuple[str, ...]):
    """Register a compiled-case dataclass as a pytree: the `arrays`
    fields are its leaves, every other field is static (hashable).

    A jitted function then takes the case as an ARGUMENT and reads its
    arrays as device buffers (closed over, they would enter the traced
    program as constants), and parallel/mesh.shard_case lays it out on
    a mesh leaf by leaf."""
    static = [f.name for f in dataclasses.fields(cls) if f.name not in arrays]
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(arrays), meta_fields=static)


def static_vec(v) -> Optional[tuple[float, ...]]:
    """A constant vector option (force, wall velocity, RCR triple) as a
    hashable tuple of floats, so it can ride as static pytree data."""
    return None if v is None else tuple(float(x) for x in v)


def _lat_axes(axis: int) -> tuple[int, int]:
    return tuple(a for a in range(3) if a != axis)  # type: ignore


def _shift_lat(arr: np.ndarray, e_lat: tuple[int, int]) -> np.ndarray:
    """Pull-shift on the last two (lateral) axes: value at x - e -> x."""
    return np.roll(arr, shift=e_lat, axis=(-2, -1))


@dataclasses.dataclass
class CompiledBC:
    """Runtime data for one PlaneBC, on its consumer plane."""

    axis: int
    consumer_coord: int
    dirs: tuple[int, ...]            # static direction indices
    valid: Any                       # (D, A, B) bool jnp
    rho_fixed: Optional[float]       # None => extrapolate rho_F
    u_mode: str
    phi_star: Any = None             # (D, A, B) f32 for fixed/field
    phi_star_series: Any = None      # (T, D, A, B) f32 for series
    series_stride: int = 1
    omega: float = 0.0               # (1 - 1/tau)
    # Windkessel (RCR) coupling (spec.PlaneBC.windkessel): the fixup's
    # rho* becomes rho_fixed + 3 (Q Rp + P_c) with P_c the carried
    # per-outlet state (engine/step.windkessel_update).
    windkessel: Optional[tuple[float, float, float]] = None
    wk_p0: float = 0.0               # initial P_c
    flow_weight: Any = None          # (A, B) f32 boundary footprint on
    #   the consumer plane: Q = flow_sign * sum(weight * u_prev[axis])
    flow_sign: float = 0.0           # -normal (outward flux positive)


register_case(CompiledBC, ("valid", "phi_star", "phi_star_series",
                           "flow_weight"))


def mrt_of(spec: CaseSpec):
    """(K, KF) f32 matrices for collision='mrt', else (None, None)."""
    if spec.collision != "mrt":
        return None, None
    from lbm_jax.core.mrt import mrt_matrices
    k, kf = mrt_matrices(spec.tau, spec.mrt_rates)
    return k.astype(np.float32), kf.astype(np.float32)


def tau_minus_of(spec: CaseSpec) -> Optional[float]:
    """TRT odd-moment relaxation time from the magic parameter, or None
    for BGK. tau_minus = 1/2 + Lambda / (tau - 1/2) (see CaseSpec)."""
    if spec.collision != "trt":
        return None
    return 0.5 + spec.magic_lambda / (spec.tau - 0.5)


@dataclasses.dataclass
class CompiledCase:
    name: str
    shape: tuple[int, int, int]
    tau: float
    tau_minus: Optional[float]       # TRT second rate; None => BGK
    force: Optional[tuple[float, float, float]]  # Guo body force | None
    wall_velocity: Optional[tuple[float, float, float]]  # MOVING walls
    nbr_moving: Any                  # (19,X,Y,Z) bool jnp | None
    mrt_k: Any                       # (19,19) f32 np | None => not MRT
    mrt_kf: Any                      # (19,19) f32 np Guo prefactor | None
    closure: Any                     # per-cell tau closure tuple
    #   (core/rheology.normalize_closure: LES or non-Newtonian) | None
    link_q: Any                      # (19,X,Y,Z) f32 jnp Bouzidi wall
    #   distances (core/bouzidi.link_q) | None => half-way staircase BB
    fluid: Any                       # (X,Y,Z) bool jnp
    nbr_wall: Any                    # (19,X,Y,Z) bool jnp
    bcs: list[CompiledBC]
    rho0: Any                        # (X,Y,Z) f32 jnp (init/static macro)
    u0: Any                          # (3,X,Y,Z) f32 jnp
    # Residual offsets: contribution of non-fluid cells, which hold their
    # init macro forever (the reference sums its persistent d_ux arrays
    # over all live cells, ldc.cu:460-466).
    velsum_offset: float
    usq_offset: float
    spec: CaseSpec


register_case(CompiledCase, ("nbr_moving", "mrt_k", "mrt_kf", "link_q",
                             "fluid", "nbr_wall", "bcs", "rho0", "u0"))


def compile_bc(bc: PlaneBC, mask: np.ndarray, tau: float,
               dtype=np.float32) -> CompiledBC:
    dirs = D3Q19.dirs_into(bc.axis, bc.normal)
    lat = _lat_axes(bc.axis)
    plane_mask = np.take(mask, bc.coord, axis=bc.axis) == bc.mask_value
    e_lats = [tuple(int(D3Q19.E[i][a]) for a in lat) for i in dirs]
    valid = np.stack([_shift_lat(plane_mask, el) for el in e_lats])

    phi_star = phi_series = None
    if bc.u_mode in ("fixed", "field"):
        if bc.u_mode == "fixed":
            a, b = plane_mask.shape
            u_star = np.broadcast_to(
                np.asarray(bc.u_value, dtype)[:, None, None], (3, a, b)
            )
        else:
            u_star = bc.u_field
        phi_star = np.stack(
            [
                _phi_np(_shift_lat(u_star, el), dirs[d : d + 1], dtype)[0]
                for d, el in enumerate(e_lats)
            ]
        )
    elif bc.u_mode == "series":
        series = bc.u_series  # (T, 3, A, B)
        phi_series = np.stack(
            [
                np.stack(
                    [
                        _phi_np(_shift_lat(series[p], el),
                                dirs[d : d + 1], dtype)[0]
                        for d, el in enumerate(e_lats)
                    ]
                )
                for p in range(series.shape[0])
            ]
        )  # (T, D, A, B)

    return CompiledBC(
        axis=bc.axis,
        consumer_coord=bc.coord + bc.normal,
        dirs=tuple(int(i) for i in dirs),
        valid=jnp.asarray(valid),
        rho_fixed=(bc.rho_value if bc.rho_mode == "fixed" else None),
        u_mode=bc.u_mode,
        phi_star=None if phi_star is None else jnp.asarray(phi_star),
        phi_star_series=None if phi_series is None else jnp.asarray(phi_series),
        series_stride=int(bc.u_series_stride),
        # fp32-compose like the reference's (1.0f - 1.0f/tau)
        # (ldc.cu:403 etc.), not f64-then-round.
        omega=float(dtype(1.0) - dtype(1.0) / dtype(tau)),
        windkessel=static_vec(bc.windkessel),
        wk_p0=float(bc.windkessel_p0),
        flow_weight=(jnp.asarray(plane_mask.astype(np.float32))
                     if bc.windkessel is not None else None),
        flow_sign=float(-bc.normal),
    )


def wk_init(bcs) -> Optional[np.ndarray]:
    """(n_wk,) f32 initial windkessel P_c states in BC order, or None —
    the scan carry the wk-aware steps thread (works on CompiledBC and
    SparseBC lists alike)."""
    p0 = [float(b.wk_p0) for b in bcs if b.windkessel is not None]
    return np.asarray(p0, np.float32) if p0 else None


def compile_case(spec: CaseSpec, dtype=np.float32) -> CompiledCase:
    """dtype: runtime precision. float32 (the reference's, default) or
    float64 for the algebraic-identity proof runs under jax x64."""
    mask = spec.mask
    fluid = mask == CellType.FLUID
    wall = mask == CellType.WALL
    has_moving = spec.wall_velocity is not None
    mrt_k, mrt_kf = mrt_of(spec)
    nbr_moving = None
    nbr_wall = np.zeros((D3Q19.Q,) + mask.shape, dtype=bool)
    for i in range(1, D3Q19.Q):
        ex, ey, ez = (int(v) for v in D3Q19.E[i])
        nbr_wall[i] = np.roll(wall, shift=(ex, ey, ez), axis=(0, 1, 2))
    if has_moving:
        moving = mask == CellType.MOVING
        nbr_moving = np.zeros((D3Q19.Q,) + mask.shape, dtype=bool)
        for i in range(1, D3Q19.Q):
            ex, ey, ez = (int(v) for v in D3Q19.E[i])
            nbr_moving[i] = np.roll(moving, shift=(ex, ey, ez),
                                    axis=(0, 1, 2))

    link_q = None
    if spec.wall_sdf is not None:
        from lbm_jax.core.bouzidi import link_q as _link_q
        link_q = jnp.asarray(_link_q(mask, spec.wall_sdf))

    u0 = spec.u0.astype(dtype)
    rho0 = spec.rho0.astype(dtype)
    nonfluid = ~fluid
    speed0 = np.sqrt(np.sum(u0.astype(np.float64) ** 2, axis=0))
    velsum_offset = float(np.sum(speed0[nonfluid], dtype=np.float64))
    usq_offset = float(np.sum(speed0[nonfluid] ** 2, dtype=np.float64))

    return CompiledCase(
        name=spec.name,
        shape=tuple(spec.shape),
        tau=float(spec.tau),
        tau_minus=tau_minus_of(spec),
        force=static_vec(spec.force),
        wall_velocity=static_vec(spec.wall_velocity),
        nbr_moving=None if nbr_moving is None else jnp.asarray(nbr_moving),
        mrt_k=mrt_k,
        mrt_kf=mrt_kf,
        closure=normalize_closure(spec.smagorinsky_cs, spec.rheology),
        link_q=link_q,
        fluid=jnp.asarray(fluid),
        nbr_wall=jnp.asarray(nbr_wall),
        bcs=[compile_bc(bc, mask, spec.tau, dtype)
             for bc in spec.boundaries],
        rho0=jnp.asarray(rho0),
        u0=jnp.asarray(u0),
        velsum_offset=velsum_offset,
        usq_offset=usq_offset,
        spec=spec,
    )


__all__ = ["CompiledBC", "CompiledCase", "compile_case", "compile_bc",
           "tau_minus_of", "mrt_of", "wk_init", "register_case",
           "static_vec"]
