"""Immersed boundary method (IBM): moving no-slip surfaces represented
by Lagrangian markers exerting a direct-forcing body force on the flow
— the last named member of the reference's Lectures method family
(/root/reference/Lectures/6.IBM.pdf is a documentation asset; the
reference ships no IBM code) and the natural moving-geometry extension
of the hemodynamics story (valve leaflets, vessel compliance — surfaces
that MOVE, which the static mask/bounce-back machinery cannot express).

Scheme (explicit diffuse-interface direct forcing, the standard IB-LBM
of Wu & Shu / multi-direct-forcing of Wang et al.):

  per step, from the pre-collision pulled state:
    u*(x)     = (sum_i e_i pulled_i + F_base/2) / rho      (engine/step)
    U*(X_m)   = sum_x u*(x) d4(x - X_m)                    (interpolate)
    F_m       = 2 rho_m (U_b(X_m) - U*(X_m)) s_m           (forcing)
    F(x)      = sum_m F_m d4(x - X_m)                      (spread)
    collide with the Guo source at force F                 (_step_tail)

  d4 is Peskin's 4-point discrete delta (support 4^3 = 64 cells,
  exactly interpolating constants and linears); s_m the marker's
  surface measure (area per marker, lattice units). n_iter > 1 runs
  the multi-direct-forcing refinement: re-interpolate u* + F/(2 rho)
  and accumulate the correction — each sweep tightens the no-slip
  defect geometrically (tests measure the first two sweeps).

The grid force enters through the SAME per-cell Guo machinery as the
Boussinesq buoyancy (step.guo_source with a field force), so IBM
composes with every collision operator the runtime-force step accepts.
Markers and their velocities are TRACED step inputs — rigid-body
motion, prescribed oscillation, or (later) elastic feedback all ride
the same step; everything is scan-/jit-/grad-compatible.

Anchors (tests/test_ibm.py): Poiseuille between IBM plates vs the
analytic parabola with the wall at the MARKER plane; the no-slip
defect at markers; Stokes' second problem (oscillating plate boundary
layer) vs the analytic e^{-kz} cos(wt - kz) profile; a translating
plate dragging fluid (Galilean consistency).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.engine.compile import CompiledCase
from lbm_jax.engine.step import (_step_tail, half_force_shift,
                                 pulled_state)


def _phi4(r):
    """Peskin's 4-point delta phi(r), support |r| < 2 (vectorized;
    exact partition of unity and first moment on the lattice)."""
    a = jnp.abs(r)
    inner = (3.0 - 2.0 * a + jnp.sqrt(jnp.maximum(
        1.0 + 4.0 * a - 4.0 * a * a, 0.0))) / 8.0
    outer = (5.0 - 2.0 * a - jnp.sqrt(jnp.maximum(
        -7.0 + 12.0 * a - 4.0 * a * a, 0.0))) / 8.0
    return jnp.where(a <= 1.0, inner,
                     jnp.where(a < 2.0, outer, 0.0))


def _support(Xm, shape):
    """(M, 64) flat cell indices + (M, 64) tensor-product weights of
    the 4^3 stencil around each marker (periodic wrap, matching the
    step's pull-roll topology)."""
    nx, ny, nz = shape
    i0 = jnp.floor(Xm).astype(jnp.int32) - 1          # (M, 3)
    offs = jnp.arange(4, dtype=jnp.int32)
    idx = i0[:, :, None] + offs[None, None, :]        # (M, 3, 4)
    r = Xm[:, :, None] - idx.astype(jnp.float32)      # (M, 3, 4)
    w = _phi4(r)                                      # (M, 3, 4)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]
    weights = (wx[:, :, None, None] * wy[:, None, :, None]
               * wz[:, None, None, :]).reshape(-1, 64)
    ix = jnp.mod(idx[:, 0], nx)
    iy = jnp.mod(idx[:, 1], ny)
    iz = jnp.mod(idx[:, 2], nz)
    flat = (ix[:, :, None, None] * (ny * nz)
            + iy[:, None, :, None] * nz
            + iz[:, None, None, :]).reshape(-1, 64)
    return flat, weights


def interp(field, flat, weights):
    """Interpolate a (C, X, Y, Z) field at markers -> (M, C)."""
    c = field.shape[0]
    fl = field.reshape(c, -1)
    vals = fl[:, flat]                                # (C, M, 64)
    return jnp.sum(vals * weights[None], axis=-1).T   # (M, C)


def spread(Fm, flat, weights, shape):
    """Spread (M, 3) marker forces -> (3, X, Y, Z) grid force."""
    contrib = Fm[:, :, None] * weights[:, None, :]    # (M, 3, 64)
    out = jnp.zeros((3, int(np.prod(shape))), jnp.float32)
    out = out.at[:, flat.reshape(-1)].add(
        contrib.transpose(1, 0, 2).reshape(3, -1))
    return out.reshape((3,) + tuple(shape))


def make_ibm_step(cc: CompiledCase, s_m=1.0, n_iter: int = 2) -> Callable:
    """(f, t, Xm, Ub) -> (f', rho, u, F_grid): one fused LBM step with
    the IBM direct-forcing body force computed from the live pulled
    state. Xm (M, 3) marker positions, Ub (M, 3) prescribed marker
    velocities — both traced (move them between or within steps at
    will). s_m: scalar or (M,) marker surface measure. n_iter:
    multi-direct-forcing sweeps."""
    assert cc.mrt_k is None, (
        "IBM's per-cell force needs the Guo source; MRT + field force "
        "is not wired (same constraint as the buoyant route)")
    shape = tuple(int(v) for v in cc.shape)
    s_col = jnp.asarray(np.broadcast_to(
        np.asarray(s_m, np.float32), (1,))) if np.isscalar(s_m) else \
        jnp.asarray(s_m, jnp.float32)[:, None]

    def step(f, t, Xm, Ub):
        pulled = pulled_state(cc, f, t)
        rho = jnp.sum(pulled, axis=0)
        mom = jnp.tensordot(
            jnp.asarray(D3Q19.E.T.astype(np.float32)), pulled,
            axes=([1], [0]), precision=jax.lax.Precision.HIGHEST)
        mom = half_force_shift(mom, cc.force)
        safe_rho = jnp.where(rho == 0, 1.0, rho)
        u_star = mom / safe_rho[None]
        flat, weights = _support(Xm, shape)
        rho_m = interp(rho[None], flat, weights)      # (M, 1)
        F_grid = jnp.zeros((3,) + shape, jnp.float32)
        u_cur = u_star
        for _ in range(n_iter):
            Um = interp(u_cur, flat, weights)         # (M, 3)
            Fm = 2.0 * rho_m * (Ub - Um) * s_col
            dF = spread(Fm, flat, weights, shape)
            F_grid = F_grid + dF
            # the half-force shift updates u immediately — the quantity
            # the next sweep's no-slip defect is measured against
            u_cur = u_cur + 0.5 * dF / safe_rho[None]
        force = F_grid if cc.force is None else half_force_base(
            F_grid, cc.force)
        f_new, rho_out, u_out = _step_tail(cc, f, pulled, force=force)
        return f_new, rho_out, u_out, F_grid

    return step


def half_force_base(F_grid, base):
    """Grid force + the case's static base force."""
    return F_grid + jnp.asarray(
        np.asarray(base, np.float32)).reshape(3, 1, 1, 1)


def marker_ring(center, radius, n, axis=1):
    """(n, 3) circle of markers in the plane normal to `axis` — a
    quasi-2D cylinder section (stack along the axis for a cylinder)."""
    th = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    c = np.asarray(center, np.float64)
    lats = [a for a in range(3) if a != axis]
    out = np.tile(c, (n, 1))
    out[:, lats[0]] += radius * np.cos(th)
    out[:, lats[1]] += radius * np.sin(th)
    return out.astype(np.float32)


def marker_plane(coord, axis, shape, spacing=1.0):
    """Markers tiling the full lattice plane `axis`=coord at the given
    spacing (an IBM membrane/plate; area per marker = spacing^2)."""
    lats = [a for a in range(3) if a != axis]
    a_ = np.arange(0.0, shape[lats[0]], spacing)
    b_ = np.arange(0.0, shape[lats[1]], spacing)
    A, B = np.meshgrid(a_, b_, indexing="ij")
    out = np.zeros((A.size, 3), np.float32)
    out[:, axis] = coord
    out[:, lats[0]] = A.ravel()
    out[:, lats[1]] = B.ravel()
    return out


class IBMFlow:
    """Driver for prescribed-motion immersed boundaries on a case:
    markers(t), velocities(t) are host callables evaluated per chunk
    boundary step count OR traced callables used inside the scan.

    motion: None (static markers) or a pair of traced callables
    (X_of_t, U_of_t) mapping the int32 step to (M, 3) arrays."""

    def __init__(self, spec, markers, s_m=1.0, n_iter: int = 2,
                 motion: Optional[tuple] = None):
        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.step import initial_f

        self.spec = spec
        self.cc = compile_case(spec)
        self.step = make_ibm_step(self.cc, s_m=s_m, n_iter=n_iter)
        self.X0 = jnp.asarray(markers, jnp.float32)
        self.motion = motion
        self.f = initial_f(self.cc)
        self.t = 0
        self._scan = {}

    def run(self, n_steps: int):
        n_steps = int(n_steps)
        if n_steps not in self._scan:
            X_of_t, U_of_t = self.motion if self.motion is not None \
                else (lambda t: self.X0,
                      lambda t: jnp.zeros_like(self.X0))

            def scan_fn(f, t0):
                def body(f, t):
                    f, rho, u, _ = self.step(f, t, X_of_t(t), U_of_t(t))
                    return f, None

                f, _ = jax.lax.scan(
                    body, f, t0 + jnp.arange(n_steps, dtype=jnp.int32))
                return f

            self._scan[n_steps] = jax.jit(scan_fn)
        self.f = self._scan[n_steps](self.f, jnp.int32(self.t))
        self.t += n_steps

    def macro(self):
        from lbm_jax.engine.step import macro_fields

        return macro_fields(self.cc, self.f)


__all__ = ["make_ibm_step", "interp", "spread", "marker_ring",
           "marker_plane", "IBMFlow"]
