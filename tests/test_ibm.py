"""Immersed boundary method tests — engine/ibm.py.

Anchors: the discrete delta's partition of unity / interpolation
exactness, Poiseuille flow between two IBM plates vs the analytic
parabola with walls AT the marker planes, the direct-forcing no-slip
defect, Stokes' second problem (oscillating plate boundary layer) vs
the analytic amplitude envelope, and composition with TRT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.ibm import (IBMFlow, _support, interp, make_ibm_step,
                                marker_plane, spread)
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)


def _free_box(shape, tau=1.0, force=None):
    mask = np.full(shape, int(CellType.FLUID), np.int32)
    return CaseSpec(name="ibm_box", shape=shape, tau=tau, units=_UNITS,
                    mask=mask, boundaries=[], force=force)


def test_delta_partition_and_linear_exactness():
    """Peskin's 4-point delta: weights sum to 1 and interpolate linear
    fields exactly, at integer AND fractional marker positions."""
    shape = (12, 12, 16)
    x, y, z = np.meshgrid(*(np.arange(s, dtype=np.float32)
                            for s in shape), indexing="ij")
    lin = jnp.asarray((2.0 + 0.5 * x + 0.25 * y - 0.125 * z)[None])
    Xm = jnp.asarray([[5.0, 6.0, 7.0], [4.3, 5.7, 8.2],
                      [3.14, 7.9, 3.5]], jnp.float32)
    flat, w = _support(Xm, shape)
    np.testing.assert_allclose(np.asarray(jnp.sum(w, axis=1)), 1.0,
                               rtol=1e-6)
    got = np.asarray(interp(lin, flat, w))[:, 0]
    want = (2.0 + 0.5 * np.asarray(Xm[:, 0])
            + 0.25 * np.asarray(Xm[:, 1]) - 0.125 * np.asarray(Xm[:, 2]))
    np.testing.assert_allclose(got, want, rtol=2e-6)
    # spreading conserves total force
    Fm = jnp.asarray([[1.0, -2.0, 0.5]] * 3, jnp.float32)
    F = spread(Fm, flat, w, shape)
    np.testing.assert_allclose(
        np.asarray(jnp.sum(F, axis=(1, 2, 3))),
        np.asarray(jnp.sum(Fm, axis=0)), rtol=1e-5)


def test_ibm_plates_poiseuille_profile():
    """Body-forced flow between two static IBM plates in a fully
    periodic box: the steady profile is the Poiseuille parabola with
    no-slip AT the marker planes (first-order diffuse interface: a few
    percent in the bulk), and the interpolated marker velocity (the
    no-slip defect) is small."""
    g = 1e-5
    z0, z1 = 2.0, 14.0
    shape = (6, 6, 24)
    spec = _free_box(shape, tau=1.0, force=(g, 0.0, 0.0))
    plates = np.concatenate([
        marker_plane(z0, 2, shape), marker_plane(z1, 2, shape)])
    flow = IBMFlow(spec, plates, n_iter=2)
    flow.run(2500)
    rho, u = flow.macro()
    ux = np.asarray(u[0][3, 3, :], np.float64)
    nu = (spec.tau - 0.5) / 3.0
    z = np.arange(shape[2], dtype=np.float64)
    zin = (z > z0 + 1.5) & (z < z1 - 1.5)
    # the diffuse 4-point interface shifts the effective wall INTO the
    # channel by O(1) cell (the documented first-order IBM behavior);
    # assert the physics that is exact regardless: the bulk profile is
    # a parabola with curvature u'' = -g/nu, and the fitted effective
    # walls sit within ~1.2 cells of the marker planes.
    coef = np.polyfit(z[zin], ux[zin], 2)
    fit = np.polyval(coef, z[zin])
    assert np.abs(fit - ux[zin]).max() < 0.01 * ux[zin].max()
    np.testing.assert_allclose(2.0 * coef[0], -g / nu, rtol=0.03)
    r1, r2 = sorted(np.roots(coef).real)
    assert abs(r1 - z0) < 1.2 and abs(r2 - z1) < 1.2, (r1, r2)
    # no-slip defect at the markers, against the channel max
    cc = compile_case(spec)
    step = jax.jit(make_ibm_step(cc, n_iter=2))
    Xm = jnp.asarray(plates)
    _, _, u_full, _ = step(flow.f, jnp.int32(flow.t), Xm,
                           jnp.zeros_like(Xm))
    flat, w = _support(Xm, shape)
    Um = np.asarray(interp(u_full, flat, w))
    assert np.abs(Um).max() < 0.05 * ux.max(), (
        np.abs(Um).max(), ux.max())


def test_ibm_multi_direct_forcing_tightens_noslip():
    """The second forcing sweep reduces the instantaneous no-slip
    defect vs a single sweep (multi-direct-forcing contract)."""
    g = 1e-5
    shape = (6, 6, 24)
    spec = _free_box(shape, tau=1.0, force=(g, 0.0, 0.0))
    plates = np.concatenate([
        marker_plane(2.0, 2, shape), marker_plane(14.0, 2, shape)])
    defects = []
    for n_iter in (1, 2):
        flow = IBMFlow(spec, plates, n_iter=n_iter)
        flow.run(600)
        cc = compile_case(spec)
        step = jax.jit(make_ibm_step(cc, n_iter=n_iter))
        Xm = jnp.asarray(plates)
        _, _, u_full, _ = step(flow.f, jnp.int32(flow.t), Xm,
                               jnp.zeros_like(Xm))
        flat, w = _support(Xm, shape)
        defects.append(float(np.abs(
            np.asarray(interp(u_full, flat, w))).max()))
    assert defects[1] < 0.6 * defects[0], defects


def test_ibm_stokes_second_problem_envelope():
    """Oscillating IBM plate: the boundary-layer oscillation amplitude
    decays as U0 e^{-k dz}, k = sqrt(omega/(2 nu)) — sampled over one
    period after 2 periods of spin-up."""
    shape = (4, 4, 48)
    tau = 0.8
    nu = (tau - 0.5) / 3.0
    period = 500
    omega = 2.0 * np.pi / period
    k = np.sqrt(omega / (2.0 * nu))
    U0 = 0.02
    zp = 24.0
    spec = _free_box(shape, tau=tau)
    plate = marker_plane(zp, 2, shape)
    X0 = jnp.asarray(plate)

    def X_of_t(t):
        return X0

    def U_of_t(t):
        u = U0 * jnp.cos(omega * t.astype(jnp.float32))
        return jnp.stack([jnp.full((X0.shape[0],), u),
                          jnp.zeros(X0.shape[0]),
                          jnp.zeros(X0.shape[0])], axis=1)

    flow = IBMFlow(spec, plate, motion=(X_of_t, U_of_t))
    flow.run(2 * period)
    samples = []
    for _ in range(10):
        flow.run(period // 10)
        samples.append(np.asarray(flow.macro()[1][0][2, 2, :]))
    amp = (np.max(samples, axis=0) - np.min(samples, axis=0)) / 2.0
    z = np.arange(shape[2], dtype=np.float64)
    dz = z - zp
    sel = (dz >= 2.0) & (dz <= 8.0)
    # log-linear fit: the decay constant must be the analytic
    # k = sqrt(omega/2nu); the intercept absorbs the O(1)-cell diffuse
    # interface shift (same first-order behavior as the channel test)
    slope, icpt = np.polyfit(dz[sel], np.log(amp[sel]), 1)
    np.testing.assert_allclose(-slope, k, rtol=0.05)
    shift = (icpt - np.log(U0)) / k        # effective origin offset
    assert abs(shift) < 1.2, shift


def test_ibm_composes_with_trt():
    """IBM's field force rides the generic Guo machinery: the TRT
    operator takes it (parity-split prefactors) and stays finite."""
    g = 1e-5
    shape = (6, 6, 20)
    spec = _free_box(shape, tau=0.8, force=(g, 0.0, 0.0))
    spec = CaseSpec(**{**spec.__dict__, "collision": "trt",
                       "magic_lambda": 0.1875})
    plates = np.concatenate([
        marker_plane(2.0, 2, shape), marker_plane(12.0, 2, shape)])
    flow = IBMFlow(spec, plates)
    flow.run(400)
    u = np.asarray(flow.macro()[1])
    assert np.isfinite(u).all() and np.abs(u[0]).max() > 1e-5
