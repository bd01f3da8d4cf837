"""Deviatoric (viscous) stress tensor and wall shear stress (WSS)
diagnostics.

Beyond-reference: the reference writes velocity and pressure only
(/root/reference/coronary_cfd/coronary.cu:948-1011) — yet WSS is THE
clinically reported quantity of coronary hemodynamics (low/oscillatory
WSS marks atherosclerosis-prone sites). LBM makes it local: the
non-equilibrium second moment

    Pi_ab = sum_i e_ia e_ib (f_i - f_i^eq)

evaluated PRE-collision relates to the strain rate by the standard
Chapman-Enskog result S_ab = -3/(2 rho tau) Pi_ab, so the deviatoric
viscous stress 2 rho nu S_ab is

    sigma_ab = -(1 - 1/(2 tau)) Pi_ab

with no velocity gradients, finite differences, or halo exchange — a
pointwise pass over the lattice (one (19->6) tensordot).
Refinements carried exactly:

  * Guo body force: the half-shifted u makes the second moment miss
    (u_a F_b + u_b F_a)/2, which is added back (Guo, Zheng & Shi 2002);
  * per-cell tau closures (LES / non-Newtonian, core/rheology.py):
    tau_eff is recomputed from the same Pi by the same fixed point the
    collide used, so sigma uses the cell's actual apparent viscosity;
  * TRT relaxes the parity-EVEN part at 1/tau and Pi is parity-even,
    and this repo's MRT fixes the shear rows at 1/tau (core/mrt.py),
    so `tau` is the right rate for every operator;
  * the stored state is POST-collision, where f_neq is already scaled
    by per-mode (1 - rate) factors — stress therefore evaluates on the
    pre-collision pulled state (engine/step.pulled_state), i.e. the
    stress field of step t+1's collision, one half-step ahead of the
    last macro() fields (identical at steady state).

Trace note: tr(Pi_neq) carries the bulk-viscous mode, O(Ma^2) in these
weakly-compressible runs; sigma keeps it (callers wanting the traceless
part subtract tr/3). WSS is unaffected either way — an isotropic stress
contributes purely normal traction.

WSS itself: at each fluid cell adjacent to a solid (WALL/MOVING) cell,
the unit inward wall normal n is estimated from the lattice directions
pointing into solid cells (w_i-weighted — the standard voxel-normal
estimate), and

    WSS = | sigma . n - (n . sigma . n) n |

i.e. the tangential traction magnitude, reported at the near-wall cell
center (half a cell off the half-way bounce-back wall plane; first
order, the standard local LBM evaluation). Physical scale:
sigma_phys = sigma_lat * C_pre (core/units.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19, phi
from lbm_jax.engine.compile import CompiledCase
from lbm_jax.engine.step import half_force_shift, pulled_state
from lbm_jax.geometry.mask import CellType

_E = D3Q19.E

# (19, 6) second-moment basis; component order xx yy zz xy xz yz.
_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
_EE6 = np.stack(
    [_E[:, a].astype(np.float32) * _E[:, b].astype(np.float32)
     for a, b in _PAIRS], axis=1)


def stress_fields(cc: CompiledCase, f, t=0, wk=None):
    """(sigma6, rho, u) of the pre-collision state pulled from f at
    step t. sigma6 is (6, X, Y, Z) in the xx yy zz xy xz yz order,
    lattice units, zero at non-fluid cells; rho/u follow the
    macro_fields convention (init values at non-fluid cells).
    wk: the carried windkessel state for RCR-outlet cases (the pull
    re-applies the BC fixups, whose outlet rho* depends on it)."""
    if wk is not None:
        from lbm_jax.engine.step import pulled_state_wk

        pulled, _ = pulled_state_wk(cc, f, t, wk)
    else:
        pulled = pulled_state(cc, f, t)
    return _sigma_from_pulled(pulled, cc.rho0, cc.u0, cc.fluid,
                              cc.tau, cc.closure, cc.force)


def _sigma_from_pulled(pulled, rho0, u0, fluid, tau, closure, force):
    """Shared stress math on any cell layout: pulled is (19, ...cells),
    returns (sigma6, rho, u) with the dense stress_fields conventions
    (sigma zero at non-fluid cells; rho/u init values there)."""
    rho = jnp.sum(pulled, axis=0)
    mom = jnp.tensordot(
        jnp.asarray(_E.T.astype(pulled.dtype)), pulled, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )
    mom = half_force_shift(mom, force)
    safe_rho = jnp.where(rho == 0, np.float32(1.0), rho)
    u = mom / safe_rho[None]
    f_eq = rho[None] * phi(u)
    pi6 = jnp.tensordot(
        jnp.asarray(_EE6.T), pulled - f_eq, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )  # (6, ...cells)
    if closure is not None:
        # the cell's actual apparent viscosity: same P, same fixed point
        # as the collide (core/rheology)
        from lbm_jax.core.rheology import tau_eff_from_p

        p = jnp.sqrt(np.float32(2.0) * (
            pi6[0] * pi6[0] + pi6[1] * pi6[1] + pi6[2] * pi6[2]
            + np.float32(2.0) * (pi6[3] * pi6[3] + pi6[4] * pi6[4]
                                 + pi6[5] * pi6[5])))
        te = tau_eff_from_p(p, np.float32(1.0) / safe_rho, tau, closure)
        pref = -(np.float32(1.0) - np.float32(0.5) / te)[None]
    else:
        pref = np.float32(-(1.0 - 0.5 / float(tau)))
    if force is not None:
        fv = np.asarray(force, np.float32)
        corr = jnp.stack([
            np.float32(0.5) * (u[a] * np.float32(fv[b])
                               + u[b] * np.float32(fv[a]))
            for a, b in _PAIRS])
        pi6 = pi6 + corr
    sigma = jnp.where(fluid[None], pref * pi6, np.float32(0.0))
    rho = jnp.where(fluid, rho, rho0)
    u = jnp.where(fluid[None], u, u0)
    return sigma, rho, u


def stress_fields_sparse(sc, f_s, t=0, wk=None):
    """(sigma6, rho, u) on the COMPACTED (19, n_live) layout — the
    capacity route for vessel trees where the dense pull does not fit
    (Simulation.stress memory note: ~5 full (19,X,Y,Z) arrays, OOM at
    512³). The pulled state comes from engine/sparse.pulled_sparse
    (same gather stream + Bouzidi + BC fixups as the sparse step), the
    stress math is shared with the dense path; scatter with
    engine/sparse.scatter_dense for a (X,Y,Z) field."""
    if wk is not None:
        from lbm_jax.engine.sparse import pulled_sparse_wk

        pulled, _ = pulled_sparse_wk(sc, f_s, t, wk)
    else:
        from lbm_jax.engine.sparse import pulled_sparse

        pulled = pulled_sparse(sc, f_s, t)
    return _sigma_from_pulled(pulled, sc.rho0, sc.u0, sc.fluid,
                              sc.tau, sc.closure, sc.force)


def compact_normals(sc, normals_dense) -> np.ndarray:
    """(3, n_live) live-cell compaction of a dense wall_normals field
    (sc.index maps dense cells -> sparse ids)."""
    idx = np.asarray(sc.index)
    livem = idx >= 0
    out = np.zeros((3, sc.n_live), np.float32)
    out[:, idx[livem]] = np.asarray(normals_dense)[:, livem]
    return out


def wall_normals(mask, sdf=None) -> np.ndarray:
    """(3, X, Y, Z) f32 unit inward (fluid->solid) wall normals at
    fluid cells with at least one WALL/MOVING lattice neighbor; zero
    elsewhere. NumPy precompute (one pass of 18 shifts over the int
    mask at case-build cost, not per-output cost).

    sdf: the case's signed distance field (CaseSpec.wall_sdf, positive
    in fluid). When given, the normal at each wall-adjacent cell is the
    (central-difference) SDF gradient, -grad(sdf)/|grad(sdf)| — the
    TRUE surface normal, replacing the w_i-weighted voxel-staircase
    estimate whose direction error is the dominant WSS error on curved
    walls (measured on the analytic pipe traction F·r/2:
    tests/test_bouzidi.py). Cells where the gradient degenerates
    (|grad| < 0.1 of a proper distance field's 1) keep the voxel
    estimate."""
    m = np.asarray(mask)
    solid = (m == CellType.WALL) | (m == CellType.MOVING)
    fluid = m == CellType.FLUID
    n = np.zeros((3,) + m.shape, np.float32)
    w = D3Q19.W.astype(np.float32)
    for i in range(1, D3Q19.Q):
        e = _E[i]
        # neighbor at x + e_i (axis-wise roll by -e)
        nb = np.roll(solid, shift=[-int(s) for s in e], axis=(0, 1, 2))
        sel = fluid & nb
        for a in range(3):
            if e[a]:
                n[a][sel] += w[i] * float(e[a])
    mag = np.sqrt((n * n).sum(axis=0))
    np.divide(n, mag[None], out=n, where=mag[None] > 0)
    if sdf is not None:
        g = np.stack(np.gradient(np.asarray(sdf, np.float64)))
        gmag = np.sqrt((g * g).sum(axis=0))
        ok = (mag > 0) & (gmag > 0.1)
        gn = (-g / np.where(gmag > 0, gmag, 1.0)).astype(np.float32)
        n = np.where(ok[None], gn, n)
    return n


def tangential_traction(cc: CompiledCase, f, t=0, normals=None, wk=None):
    """(3, X, Y, Z) tangential wall-traction VECTOR (lattice units) at
    wall-adjacent fluid cells, zero elsewhere — the directional
    quantity under WSS, kept separate because pulsatile statistics
    (OSI) need the vector's time average, not the magnitude's."""
    if normals is None:
        normals = wall_normals(cc.spec.mask, cc.spec.wall_sdf)
    sigma, _, _ = stress_fields(cc, f, t, wk=wk)
    return _tangential(sigma, jnp.asarray(normals))


def _tangential(sigma, n):
    """Tangential traction vector from a packed (6, ...cells) sigma and
    (3, ...cells) unit normals (any cell layout)."""
    # traction t_a = sigma_ab n_b from the packed 6 components
    tx = sigma[0] * n[0] + sigma[3] * n[1] + sigma[4] * n[2]
    ty = sigma[3] * n[0] + sigma[1] * n[1] + sigma[5] * n[2]
    tz = sigma[4] * n[0] + sigma[5] * n[1] + sigma[2] * n[2]
    tn = tx * n[0] + ty * n[1] + tz * n[2]
    return jnp.stack([tx - tn * n[0], ty - tn * n[1], tz - tn * n[2]])


def wss_sparse(sc, f_s, t=0, normals=None, wk=None):
    """(n_live,) wall shear stress magnitude on the compacted layout
    (stress_fields_sparse; the 512³-capable route — everything here is
    O(live cells)). normals: a compact_normals(sc, wall_normals(...))
    to amortize over repeated outputs."""
    if normals is None:
        normals = compact_normals(
            sc, wall_normals(sc.spec.mask, sc.spec.wall_sdf))
    sigma, _, _ = stress_fields_sparse(sc, f_s, t, wk=wk)
    n = jnp.asarray(normals)
    w = _tangential(sigma, n)
    has_wall = (n != 0).any(axis=0)
    return jnp.where(has_wall,
                     jnp.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]),
                     np.float32(0.0))


def wss_field(cc: CompiledCase, f, t=0, normals=None, wk=None):
    """(X, Y, Z) wall shear stress magnitude (lattice units; multiply
    by units.C_pre for Pa), nonzero exactly at wall-adjacent fluid
    cells. normals: a precomputed wall_normals(mask) to amortize over
    repeated outputs."""
    if normals is None:
        normals = wall_normals(cc.spec.mask, cc.spec.wall_sdf)
    w = tangential_traction(cc, f, t, normals, wk=wk)
    has_wall = jnp.asarray((normals != 0).any(axis=0))
    return jnp.where(has_wall,
                     jnp.sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]),
                     np.float32(0.0))


class _WSSStats:
    """Shared TAWSS/OSI math over any cell layout — the clinical pair
    for pulsatile hemodynamics:

        TAWSS = < |t_w| >                    (time-averaged WSS)
        OSI   = 1/2 (1 - |<t_w>| / <|t_w|>)  (oscillatory shear index)

    OSI = 0 for unidirectional traction, -> 1/2 for fully reversing
    flow; low-TAWSS/high-OSI sites mark atherosclerosis-prone
    endothelium (Ku et al. 1985 — the reason WSS is computed at all).
    Sampling cost is one stress pass per call; sample uniformly over
    whole periods (e.g. from a Simulation on_save callback, or
    `acc.sample_sim(sim)` after each chunk)."""

    def _init_stats(self, cells_shape):
        self._vec = jnp.zeros((3,) + tuple(cells_shape), jnp.float32)
        self._mag = jnp.zeros(tuple(cells_shape), jnp.float32)
        self.n_samples = 0

    def _accumulate(self, w):
        self._vec = self._vec + w
        self._mag = self._mag + jnp.sqrt(
            w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
        self.n_samples += 1

    def tawss(self):
        """Time-averaged WSS (lattice units), on this accumulator's
        cell layout."""
        assert self.n_samples > 0
        return self._mag / np.float32(self.n_samples)

    def osi(self):
        """Oscillatory shear index in [0, 1/2], zero where there is no
        wall (and where TAWSS is identically zero)."""
        assert self.n_samples > 0
        mean_vec = jnp.sqrt(self._vec[0] ** 2 + self._vec[1] ** 2
                            + self._vec[2] ** 2)
        safe = jnp.where(self._mag > 0, self._mag, np.float32(1.0))
        return jnp.where(
            self._mag > 0,
            np.float32(0.5) * (np.float32(1.0) - mean_vec / safe),
            np.float32(0.0))


class WSSAccumulator(_WSSStats):
    """Dense-layout traction statistics (see _WSSStats); fields come
    back (X, Y, Z)."""

    def __init__(self, cc: CompiledCase, normals=None):
        self.cc = cc
        self.normals = (wall_normals(cc.spec.mask, cc.spec.wall_sdf)
                        if normals is None else normals)
        self._init_stats(cc.spec.shape)

    def sample(self, f, t=0, wk=None):
        self._accumulate(
            tangential_traction(self.cc, f, t, self.normals, wk=wk))

    def sample_sim(self, sim):
        """Sample a Simulation's current state (any backend)."""
        cc, f = sim._dense_cc_f()
        assert cc is self.cc, "accumulator bound to a different case"
        self.sample(f, sim.t, wk=getattr(sim, "wk", None))

    # dense-(X,Y,Z)-guaranteed accessors (layout-erasing API shared
    # with SparseWSSAccumulator, e.g. for VTK writes)
    tawss_field = _WSSStats.tawss
    osi_field = _WSSStats.osi


class SparseWSSAccumulator(_WSSStats):
    """Compacted-layout traction statistics (see _WSSStats) — the
    O(live-cell) route for vessel trees past the dense pull's memory
    wall (Simulation.stress note; 512³). tawss()/osi() come back
    (n_live,); scatter with engine/sparse.scatter_dense."""

    def __init__(self, sc, normals=None):
        self.sc = sc
        self.normals = (
            compact_normals(sc, wall_normals(sc.spec.mask,
                                             sc.spec.wall_sdf))
            if normals is None else normals)
        self._init_stats((sc.n_live,))

    def sample(self, f_s, t=0, wk=None):
        sigma, _, _ = stress_fields_sparse(self.sc, f_s, t, wk=wk)
        self._accumulate(_tangential(sigma, jnp.asarray(self.normals)))

    def sample_sim(self, sim):
        """Sample a sparse-backend Simulation's current state."""
        sc, f_s = sim._sparse_cc_f()
        assert sc is self.sc, "accumulator bound to a different case"
        self.sample(f_s, sim.t, wk=getattr(sim, "wk", None))

    def tawss_field(self):
        """(X, Y, Z) dense TAWSS (one scattered field; fine at 512³)."""
        from lbm_jax.engine.sparse import scatter_dense

        return scatter_dense(self.sc, self.tawss())

    def osi_field(self):
        """(X, Y, Z) dense OSI."""
        from lbm_jax.engine.sparse import scatter_dense

        return scatter_dense(self.sc, self.osi())


__all__ = ["stress_fields", "stress_fields_sparse", "wall_normals",
           "compact_normals", "wss_field", "wss_sparse",
           "tangential_traction", "WSSAccumulator",
           "SparseWSSAccumulator"]
