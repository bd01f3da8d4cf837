"""Sparse node-compaction engine: gather/scatter over live cells only.

The reference's `index_transform` (Poiseulle.cu:257-271) compacts the
lattice to live cells so vessel geometries don't pay memory for dead
lattice (memory = (Q+4) floats per live cell, thesis §4.5-B), with a
texture-cached spatial->dense index per access. The analogue here:

  - state is f_s (19, N) over the N live cells in compaction order
    (z-major, x-fastest — matching compact_index);
  - streaming is a precomputed gather: nbr_idx[i, k] is the compact id of
    cell_k - e_i, and the fused half-way bounce-back becomes a
    select between the gathered value and the cell's own opposite pdf
    (see engine/step.py for why this fusion is exact);
  - NEE boundaries apply on precomputed consumer-cell id lists (small K);
  - non-fluid live cells (walls, ghosts, BC cells) are carried but never
    updated, exactly like the reference's NLATTICE arrays.

Trade-off vs the dense engine: the index array doubles streaming traffic
(~228 B/live cell vs 152 B/dense cell), so by bytes moved sparse should
win when occupancy is below ~60% — the coronary-tree regime — and the
dense step on mostly-full boxes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19, phi
from lbm_jax.core.rheology import normalize_closure
from lbm_jax.engine.compile import (CompiledBC, compile_bc, mrt_of,
                                    register_case, static_vec,
                                    tau_minus_of)
from lbm_jax.engine.step import guo_source, half_force_shift, moving_bb_terms
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType, compact_index

_E = D3Q19.E
_OPP = D3Q19.OPP
_EF = _E.astype(np.float32)


@dataclasses.dataclass
class SparseBC:
    dirs: tuple[int, ...]
    ids: Any            # (K,) int32 consumer compact ids
    valid: Any          # (D, K) bool
    phi_star: Any       # (D, K) f32, or None (u extrapolated)
    phi_star_series: Any  # (T, D, K) or None
    series_stride: int
    rho_fixed: Any      # float | None
    omega: float
    # Windkessel (RCR) coupling (spec.PlaneBC.windkessel; see
    # engine/step.windkessel_update): rho* = rho_fixed + 3 (Q Rp + P_c)
    windkessel: Any = None   # (Rp, C, Rd) | None
    wk_p0: float = 0.0
    axis: int = 0            # plane axis (flux component of u)
    flow_weight: Any = None  # (K,) f32 boundary footprint weights
    flow_sign: float = 0.0   # -normal (outward flux positive)


register_case(SparseBC, ("ids", "valid", "phi_star", "phi_star_series",
                         "flow_weight"))


@dataclasses.dataclass
class SparseCase:
    name: str
    n_live: int
    tau: float
    tau_minus: Any      # TRT second rate (float) | None => BGK
    force: Any          # Guo body force (3-tuple) | None
    mrt_k: Any          # (19,19) f32 | None (core/mrt)
    mrt_kf: Any         # (19,19) f32 | None
    closure: Any        # per-cell tau closure tuple (core/rheology) | None
    wall_velocity: Any  # MOVING wall velocity (3-tuple) | None
    nbr_moving: Any     # (19, n_live) bool | None
    fluid: Any          # (n_live,) bool
    nbr_idx: Any        # (19, n_live) int32 (clamped to valid range)
    nbr_wall: Any       # (19, n_live) bool
    link_q: Any         # (19, n_live) f32 Bouzidi wall distances
    #   compacted to live cells (core/bouzidi) | None => half-way BB
    bcs: list[SparseBC]
    rho0: Any           # (n_live,) f32
    u0: Any             # (3, n_live) f32
    velsum_offset: float
    spec: CaseSpec

    @functools.cached_property
    def index(self) -> np.ndarray:
        """(nx, ny, nz) spatial -> compact id map (-1 dead), host-side
        (geometry/mask.compact_index of the spec's mask)."""
        return compact_index(np.asarray(self.spec.mask))[0]


register_case(SparseCase, ("nbr_moving", "mrt_k", "mrt_kf", "fluid",
                           "nbr_idx", "nbr_wall", "link_q", "bcs", "rho0",
                           "u0"))


def _flatten_ids(index: np.ndarray, coords):
    return index[coords[:, 0], coords[:, 1], coords[:, 2]]


def compile_sparse(spec: CaseSpec) -> SparseCase:
    mask = np.asarray(spec.mask)
    nx, ny, nz = mask.shape
    index, n_live = compact_index(mask)

    mrt_k, mrt_kf = mrt_of(spec)
    live = np.argwhere(mask != CellType.DEAD)  # (N, 3) in x,y,z
    order = np.lexsort((live[:, 0], live[:, 1], live[:, 2]))
    live = live[order]  # compaction order: z-major, x fastest
    assert (
        _flatten_ids(index, live) == np.arange(n_live)
    ).all(), "compaction order mismatch"

    cell_mask = mask[live[:, 0], live[:, 1], live[:, 2]]
    fluid = cell_mask == CellType.FLUID

    nbr_idx = np.zeros((19, n_live), np.int32)
    nbr_wall = np.zeros((19, n_live), bool)
    has_moving = spec.wall_velocity is not None
    nbr_moving = np.zeros((19, n_live), bool) if has_moving else None
    shape = np.array([nx, ny, nz])
    for i in range(1, 19):
        src = (live - _E[i]) % shape  # pull source, with roll-style wrap
        sid = _flatten_ids(index, src)
        smask = mask[src[:, 0], src[:, 1], src[:, 2]]
        nbr_wall[i] = smask == CellType.WALL
        if has_moving:
            nbr_moving[i] = smask == CellType.MOVING
        # Dead sources (only reachable from non-fluid cells) clamp to 0.
        nbr_idx[i] = np.where(sid >= 0, sid, 0)

    link_q = None
    if spec.wall_sdf is not None:
        from lbm_jax.core.bouzidi import link_q as _link_q
        qd = _link_q(mask, spec.wall_sdf)  # (19, nx, ny, nz)
        link_q = qd[:, live[:, 0], live[:, 1], live[:, 2]].astype(
            np.float32)
        # the q<1/2 far gather rides direction opp(i)'s nbr_idx; dead
        # fallbacks are already folded to q=1/2 (b_up = 0) by link_q

    bcs = []
    for bc in spec.boundaries:
        cbc: CompiledBC = compile_bc(bc, mask, spec.tau)
        dirs = cbc.dirs
        lat = [a for a in range(3) if a != bc.axis]
        c = cbc.consumer_coord
        # Consumer cells: every LIVE cell on the consumer plane (validity
        # per direction comes from the shifted valid masks).
        plane_live = live[live[:, bc.axis] == c]
        ids = _flatten_ids(index, plane_live)
        la, lb = plane_live[:, lat[0]], plane_live[:, lat[1]]
        valid = np.stack([np.asarray(cbc.valid)[d, la, lb]
                          for d in range(len(dirs))])
        phi_star = None
        series = None
        if cbc.phi_star is not None:
            phi_star = np.stack(
                [np.asarray(cbc.phi_star)[d, la, lb]
                 for d in range(len(dirs))]
            )
        if cbc.phi_star_series is not None:
            s = np.asarray(cbc.phi_star_series)
            series = np.stack(
                [
                    np.stack([s[t, d, la, lb] for d in range(len(dirs))])
                    for t in range(s.shape[0])
                ]
            )
        flow_weight = None
        if cbc.windkessel is not None:
            flow_weight = np.asarray(cbc.flow_weight)[la, lb]
        bcs.append(
            SparseBC(
                dirs=dirs,
                ids=jnp.asarray(ids.astype(np.int32)),
                valid=jnp.asarray(valid),
                phi_star=None if phi_star is None else jnp.asarray(phi_star),
                phi_star_series=None if series is None else jnp.asarray(series),
                series_stride=cbc.series_stride,
                rho_fixed=cbc.rho_fixed,
                omega=cbc.omega,
                windkessel=cbc.windkessel,
                wk_p0=cbc.wk_p0,
                axis=bc.axis,
                flow_weight=(None if flow_weight is None
                             else jnp.asarray(flow_weight)),
                flow_sign=cbc.flow_sign,
            )
        )

    rho0 = np.asarray(spec.rho0, np.float32)[live[:, 0], live[:, 1],
                                             live[:, 2]]
    u0 = np.asarray(spec.u0, np.float32)[:, live[:, 0], live[:, 1],
                                         live[:, 2]]
    speed0 = np.sqrt((u0.astype(np.float64) ** 2).sum(axis=0))
    velsum_offset = float(speed0[~fluid].sum())

    return SparseCase(
        name=spec.name,
        n_live=n_live,
        tau=float(spec.tau),
        tau_minus=tau_minus_of(spec),
        force=static_vec(spec.force),
        mrt_k=mrt_k,
        mrt_kf=mrt_kf,
        closure=normalize_closure(spec.smagorinsky_cs, spec.rheology),
        wall_velocity=static_vec(spec.wall_velocity),
        nbr_moving=None if nbr_moving is None else jnp.asarray(nbr_moving),
        fluid=jnp.asarray(fluid),
        nbr_idx=jnp.asarray(nbr_idx),
        nbr_wall=jnp.asarray(nbr_wall),
        link_q=None if link_q is None else jnp.asarray(link_q),
        bcs=bcs,
        rho0=jnp.asarray(rho0),
        u0=jnp.asarray(u0),
        velsum_offset=velsum_offset,
        spec=spec,
    )


def initial_f_sparse(sc: SparseCase):
    return sc.rho0[None] * phi(sc.u0)


def _bc_apply(pulled, f_s, bc: SparseBC, t, tau, force=None, wk_p=None):
    """NEE overwrite on the consumer id list (gathered small-K work).
    wk_p: carried windkessel P_c for an RCR-coupled outlet (see
    engine/step.apply_bc_fixup) — returns (pulled, P_c') then."""
    ids = bc.ids
    src = f_s[:, ids]  # (19, K)
    rho_p = jnp.sum(src, axis=0)
    mom = jnp.tensordot(jnp.asarray(_EF.T), src, axes=([1], [0]),
                        precision=jax.lax.Precision.HIGHEST)
    mom = half_force_shift(mom, force)
    u_p = mom / jnp.where(rho_p == 0, 1.0, rho_p)[None]
    phi_nbr = phi(u_p, dirs=bc.dirs)  # (D, K)
    if bc.phi_star is not None:
        phi_star = bc.phi_star
    elif bc.phi_star_series is not None:
        T = bc.phi_star_series.shape[0]
        phase = (t // bc.series_stride) % T
        phi_star = jax.lax.dynamic_index_in_dim(
            bc.phi_star_series, phase, 0, False
        )
    else:
        phi_star = phi_nbr
    p_new = None
    if bc.windkessel is not None:
        from lbm_jax.engine.step import windkessel_update
        assert wk_p is not None, (
            "windkessel-coupled BC needs its carried P_c state (use "
            "make_sparse_step_wk / pulled_sparse_wk)"
        )
        q = np.float32(bc.flow_sign) * jnp.sum(bc.flow_weight
                                               * u_p[bc.axis])
        p_new, p_in = windkessel_update(wk_p, q, bc.windkessel)
        rho_star = np.float32(bc.rho_fixed) + np.float32(3.0) * p_in
    elif bc.rho_fixed is not None:
        rho_star = bc.rho_fixed
    else:
        rho_star = rho_p[None]
    val = rho_star * phi_star + (src[jnp.asarray(bc.dirs)]
                                 - rho_p[None] * phi_nbr) * bc.omega
    for d, i in enumerate(bc.dirs):
        cur = pulled[i, ids]
        pulled = pulled.at[i, ids].set(jnp.where(bc.valid[d], val[d], cur))
    return pulled if wk_p is None else (pulled, p_new)


def _streamed_sparse(sc: SparseCase, f_s, bb):
    """Gather stream + fused bounce-back (half-way or Bouzidi) + moving
    walls on the compacted layout, before any BC fixup."""
    if bb is None and sc.wall_velocity is not None:
        bb = moving_bb_terms(sc.wall_velocity)
    pulled = [f_s[0]]
    for i in range(1, 19):
        g = jnp.take(f_s[i], sc.nbr_idx[i], axis=0)
        if sc.link_q is None:
            v = jnp.where(sc.nbr_wall[i], f_s[_OPP[i]], g)
        else:
            from lbm_jax.core.bouzidi import bouzidi_coeffs
            a, b_up, b_loc = bouzidi_coeffs(sc.link_q[i])
            # far node x + e_i == opp(i)'s own gather (XLA CSEs it)
            up = jnp.take(f_s[_OPP[i]], sc.nbr_idx[_OPP[i]], axis=0)
            bz = a * f_s[_OPP[i]] + b_up * up + b_loc * f_s[i]
            v = jnp.where(sc.nbr_wall[i], bz, g)
        if bb is not None:
            v = jnp.where(sc.nbr_moving[i], f_s[_OPP[i]] + bb[i], v)
        pulled.append(v)
    return jnp.stack(pulled)


def pulled_sparse(sc: SparseCase, f_s, t, bb=None):
    """The pre-collision pulled state on the compacted layout: gather
    stream + fused bounce-back (half-way or Bouzidi) + moving walls +
    NEE BC fixups — the sparse mirror of engine/step.pulled_state,
    shared by the step and the stress diagnostics. Windkessel cases
    carry per-outlet state: use pulled_sparse_wk."""
    from lbm_jax.engine.step import has_windkessel
    assert not has_windkessel(sc.bcs), (
        "case has windkessel outlets; use pulled_sparse_wk with the "
        "carried state"
    )
    pulled = _streamed_sparse(sc, f_s, bb)
    for bc in sc.bcs:
        pulled = _bc_apply(pulled, f_s, bc, t, sc.tau, force=sc.force)
    return pulled


def pulled_sparse_wk(sc: SparseCase, f_s, t, wk, bb=None):
    """pulled_sparse for windkessel cases: wk is the (n_wk,) carried P_c
    vector (compile.wk_init(sc.bcs) order); returns (pulled, wk')."""
    pulled = _streamed_sparse(sc, f_s, bb)
    k = 0
    wk_new = []
    for bc in sc.bcs:
        if bc.windkessel is not None:
            pulled, p = _bc_apply(pulled, f_s, bc, t, sc.tau,
                                  force=sc.force, wk_p=wk[k])
            wk_new.append(p)
            k += 1
        else:
            pulled = _bc_apply(pulled, f_s, bc, t, sc.tau, force=sc.force)
    return pulled, jnp.stack(wk_new)


def _sparse_step_tail(sc: SparseCase, f_s, pulled):
    """Moments + collide + Guo source + fluid mask — the shared tail of
    make_sparse_step / make_sparse_step_wk."""
    inv_tau = 1.0 / sc.tau
    # TRT (see engine/step.collide): even/odd parity halves relax at
    # their own rates; this backend keeps its multiplicative style.
    hp = None if sc.tau_minus is None else np.float32(0.5 * inv_tau)
    hm = None if sc.tau_minus is None else np.float32(0.5 / sc.tau_minus)
    rho = jnp.sum(pulled, axis=0)
    mom = jnp.tensordot(jnp.asarray(_EF.T), pulled, axes=([1], [0]),
                        precision=jax.lax.Precision.HIGHEST)
    mom = half_force_shift(mom, sc.force)
    u = mom / jnp.where(rho == 0, 1.0, rho)[None]
    f_eq = rho[None] * phi(u)
    if sc.closure is not None:
        from lbm_jax.core.rheology import tau_eff
        from lbm_jax.engine.step import closure_tau_minus
        fneq = pulled - f_eq
        te = tau_eff(fneq, rho, sc.tau, sc.closure)
        te_m = None
        if sc.tau_minus is not None:   # TRT + closure (engine/step)
            te_m = closure_tau_minus(te, sc.tau, sc.tau_minus)
            opp = jnp.asarray(_OPP)
            s_neq = fneq + fneq[opp]
            d_neq = fneq - fneq[opp]
            f_post = (pulled - s_neq / (2.0 * te[None])
                      - d_neq / (2.0 * te_m[None]))
        else:
            f_post = pulled - fneq / te[None]
        if sc.force is not None:
            f_post = f_post + guo_source(u, sc.force, sc.tau,
                                         tau_local=te,
                                         tau_local_minus=te_m)
        f_new = jnp.where(sc.fluid[None], f_post, f_s)
        return f_new, rho, u
    if sc.mrt_k is not None:
        fneq = pulled - f_eq
        f_post = pulled - jnp.tensordot(
            jnp.asarray(sc.mrt_k), fneq, axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST)
    elif hp is None:
        f_post = pulled - (pulled - f_eq) * inv_tau
    else:
        opp = jnp.asarray(_OPP)
        f_post = (pulled
                  - ((pulled + pulled[opp]) - (f_eq + f_eq[opp])) * hp
                  - ((pulled - pulled[opp]) - (f_eq - f_eq[opp])) * hm)
    if sc.force is not None:
        f_post = f_post + guo_source(u, sc.force, sc.tau,
                                     sc.tau_minus, sc.mrt_kf)
    f_new = jnp.where(sc.fluid[None], f_post, f_s)
    return f_new, rho, u


def make_sparse_step(sc: SparseCase) -> Callable:
    bb = (None if sc.wall_velocity is None
          else moving_bb_terms(sc.wall_velocity))

    def step(f_s, t):
        pulled = pulled_sparse(sc, f_s, t, bb)
        return _sparse_step_tail(sc, f_s, pulled)

    return step


def make_sparse_step_wk(sc: SparseCase) -> Callable:
    """The sparse step for windkessel (RCR) outlet cases:
    (f_s, t, wk) -> (f_s', rho, u, wk')."""
    bb = (None if sc.wall_velocity is None
          else moving_bb_terms(sc.wall_velocity))

    def step(f_s, t, wk):
        pulled, wk_new = pulled_sparse_wk(sc, f_s, t, wk, bb)
        f_new, rho, u = _sparse_step_tail(sc, f_s, pulled)
        return f_new, rho, u, wk_new

    return step


def scatter_dense(sc: SparseCase, arr_sparse, fill=0.0):
    """(..., n_live) sparse field -> (..., nx, ny, nz) dense field."""
    idx = jnp.asarray(np.maximum(sc.index, 0))
    dense = jnp.take(arr_sparse, idx, axis=-1)
    livem = jnp.asarray(sc.index >= 0)
    return jnp.where(livem, dense, fill)


def macro_fields_sparse(sc: SparseCase, f_s):
    rho = jnp.sum(f_s, axis=0)
    mom = jnp.tensordot(jnp.asarray(_EF.T), f_s, axes=([1], [0]),
                        precision=jax.lax.Precision.HIGHEST)
    mom = half_force_shift(mom, sc.force)
    u = mom / jnp.where(rho == 0, 1.0, rho)[None]
    rho = jnp.where(sc.fluid, rho, sc.rho0)
    u = jnp.where(sc.fluid[None], u, sc.u0)
    return rho, u


__all__ = [
    "SparseCase",
    "compile_sparse",
    "initial_f_sparse",
    "make_sparse_step",
    "make_sparse_step_wk",
    "pulled_sparse",
    "pulled_sparse_wk",
    "macro_fields_sparse",
    "scatter_dense",
]
