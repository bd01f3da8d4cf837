"""Published-table physics anchors (SURVEY.md section 4 / VERDICT r1):

1. Ghia, Ghia & Shin (1982) lid-driven cavity, Re=100: centerline
   velocity profiles vs their Table I/II (129x129 multigrid NS).
2. Womersley pulsatile pipe flow vs the analytic oscillatory solution
   u(r,t) = Re{A [1 - J0(i^{3/2} a r/R)/J0(i^{3/2} a)] e^{iwt}}.

Both are SLOW (tens of thousands of steps on the CPU backend) and marked
accordingly. They anchor the solver to external ground truth — something
the reference itself never shipped (its validation was a manual
STAR-CCM+ comparison, thesis section 4.9.2, <2% errors).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.engine.step import initial_f, macro_fields, make_step
from lbm_jax.geometry.mask import CellType

# --- Ghia, Ghia & Shin (1982), Re=100, Tables I & II ---------------------
# u through the vertical centerline (y from lid=1 to floor=0):
GHIA_Y = np.array([
    0.9766, 0.9688, 0.9609, 0.9531, 0.8516, 0.7344, 0.6172, 0.5000,
    0.4531, 0.2813, 0.1719, 0.1016, 0.0703, 0.0625, 0.0547,
])
GHIA_U = np.array([
    0.84123, 0.78871, 0.73722, 0.68717, 0.23151, 0.00332, -0.13641,
    -0.20581, -0.21090, -0.15662, -0.10150, -0.06434, -0.04775,
    -0.04192, -0.03717,
])
# v through the horizontal centerline (x along the lid direction):
GHIA_X = np.array([
    0.9688, 0.9609, 0.9531, 0.9453, 0.9063, 0.8594, 0.8047, 0.5000,
    0.2344, 0.2266, 0.1563, 0.0938, 0.0781, 0.0703, 0.0625,
])
GHIA_V = np.array([
    -0.05906, -0.07391, -0.08864, -0.10313, -0.16914, -0.22445,
    -0.24533, 0.05454, 0.17527, 0.17507, 0.16077, 0.12317, 0.10890,
    0.10091, 0.09233,
])


def _ghia_cavity_spec(n: int, u_lid: float, re: float,
                      lid: str = "nee") -> CaseSpec:
    """Quasi-2D cavity: x is INVARIANT (no x walls; the engine's pulls
    wrap, giving exact periodicity), lid at y=n-2 moving along +z —
    the true 2D benchmark geometry at nx=4 cost. lid='bounceback'
    swaps the NEE lid for a MOVING wall (Ladd bounce-back,
    CaseSpec.wall_velocity) — anchoring the beyond-reference moving-
    boundary treatment to the same external table."""
    nx = 4
    mask = np.zeros((nx, n, n), np.int32)
    mask[:, 1:-1, 1:-1] = CellType.WALL
    mask[:, 2:-2, 2:-2] = CellType.FLUID
    nu = u_lid * (n - 4) / re
    tau = 0.5 + 3.0 * nu
    wall_velocity = None
    if lid == "nee":
        mask[:, n - 2, 1:-1] = CellType.INLET
        boundaries = [PlaneBC(
            mask_value=int(CellType.INLET), axis=1, coord=n - 2,
            normal=-1, rho_mode="extrapolate", u_mode="fixed",
            u_value=(0.0, 0.0, u_lid),
        )]
    else:
        mask[:, n - 2, 1:-1] = CellType.MOVING
        boundaries = []
        wall_velocity = (0.0, 0.0, u_lid)
    u0 = np.zeros((3, nx, n, n), np.float32)
    u0[2, :, n - 1, :] = u_lid
    u0[2, :, n - 2, :] = u_lid
    return CaseSpec(
        name="ghia_cavity", shape=(nx, n, n), tau=tau,
        units=UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0),
        mask=mask, boundaries=boundaries, u0=u0,
        wall_velocity=wall_velocity,
        max_steps=200000, time_save=1000, tol=1e-8, stag_max=5,
    )


@pytest.mark.slow
@pytest.mark.parametrize("lid", ["nee", "bounceback"])
def test_ghia_cavity_re100(lid):
    n, u_lid, re = 64, 0.1, 100.0
    spec = _ghia_cavity_spec(n, u_lid, re, lid=lid)
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))

    def chunk(f, t0, ln=1000):
        def body(carry, _):
            f, t = carry
            f, rho, u = step(f, t)
            return (f, t + 1), ()
        (f, _), _ = jax.lax.scan(body, (f, t0), xs=None, length=ln)
        return f

    run = jax.jit(chunk, static_argnums=(2,))
    f = initial_f(cc)
    prev = None
    for k in range(80):
        f = run(f, jnp.int32(k * 1000))
        _, u = macro_fields(cc, f)
        uz = np.asarray(u[2, 1])  # any x slab (x-invariant)
        if prev is not None:
            d = np.abs(uz - prev).max() / u_lid
            if d < 2e-7:
                break
        prev = uz
    _, u = macro_fields(cc, f)
    u = np.asarray(u)

    # Half-way walls sit at the half-links: bottom y=1.5, sides z=1.5
    # and z=n-2.5 (wall NODES are the 1-shell at 1 and n-2, fluid spans
    # 2..n-3); the lid's velocity node is AT y=n-2.
    # Empirically the NEE lid also acts half a cell inside its node
    # plane (profile match places the moving surface at y = n-2.5, like
    # the bounce-back walls) -> a square (n-4) x (n-4) cavity.
    ys = (np.arange(n) - 1.5) / (n - 4.0)
    zs = (np.arange(n) - 1.5) / (n - 4.0)

    # Vertical centerline (Ghia x=0.5 -> z center), u = lid-direction uz.
    zc = 0.5 * (1.5 + (n - 2.5))
    z0 = int(np.floor(zc))
    wz = zc - z0
    prof_u = (1 - wz) * u[2, 1, :, z0] + wz * u[2, 1, :, z0 + 1]
    sim_u = np.interp(GHIA_Y, ys, prof_u / u_lid)
    err_u = np.abs(sim_u - GHIA_U).max()

    # Horizontal centerline (Ghia y=0.5), v = wall-normal uy.
    yc = 1.5 + 0.5 * (n - 4.0)
    y0 = int(np.floor(yc))
    wy = yc - y0
    prof_v = (1 - wy) * u[1, 1, y0, :] + wy * u[1, 1, y0 + 1, :]
    sim_v = np.interp(GHIA_X, zs, prof_v / u_lid)
    err_v = np.abs(sim_v - GHIA_V).max()

    assert err_u < 0.03, f"Ghia u-profile max dev {err_u:.4f} (>3% of lid)"
    assert err_v < 0.03, f"Ghia v-profile max dev {err_v:.4f} (>3% of lid)"


# --- Womersley pulsatile pipe ---------------------------------------------

def _j0_complex(z, terms: int = 30):
    """Bessel J0 via its power series (converges fast for |z| <~ 10)."""
    out = np.zeros_like(z, dtype=np.complex128)
    term = np.ones_like(z, dtype=np.complex128)
    out += term
    q = -(z * z) / 4.0
    for k in range(1, terms):
        term = term * q / (k * k)
        out += term
    return out


def womersley_profile(r_over_R, alpha, t_phase):
    """Re{[1 - J0(i^1.5 a r/R)/J0(i^1.5 a)] e^{i phase}} (unit amplitude)."""
    lam = 1j**1.5 * alpha
    shape = (1.0 - _j0_complex(lam * r_over_R) / _j0_complex(np.asarray(lam)))
    return np.real(shape * np.exp(1j * t_phase))


@pytest.mark.slow
def test_womersley_pipe():
    """Drive a straight pipe's inlet AND outlet with the analytic
    oscillatory Womersley profile (u_mode='series'); after spin-up the
    mid-pipe cross-section must be a Womersley field — the physics
    anchor for the unsteady-BC machinery (the reference describes the
    capability for its curved-vessel case but ships no code).

    Two-part assertion (the interior relaxes to the DISCRETE wall's own
    Womersley mode at the continuity-enforced flow rate, so a pointwise
    compare against the imposed profile conflates wall-position
    discretization with physics):
      1. the mid-pipe flow-rate waveform matches the imposed one in
         amplitude and phase (continuity; measured 1.00 / -0.02 rad), and
      2. the space-time field matches Re{C U(r) e^{iwt}} — the analytic
         radial shape (Stokes layer + annular phase lead) — for a single
         fitted complex amplitude and an effective radius within the
         staircase-wall uncertainty band derived from the mask (the
         eroded wall ring puts the bounce-back surface ~1 cell inside
         the nominal disc; measured best-fit rms 2.2%)."""
    from lbm_jax.geometry.shapes import pipe_mask

    nxz, ny = 32, 64
    tau = 0.58
    nu = (tau - 0.5) / 3.0
    period = 2000
    omega = 2.0 * np.pi / period
    R = (nxz - 1) / 2.0 + 0.5
    alpha = R * np.sqrt(omega / nu)
    amp = 0.04

    cx = cz = (nxz - 1) / 2.0
    x = np.arange(nxz)[:, None]
    z = np.arange(nxz)[None, :]
    r = np.sqrt((x - cx) ** 2 + (z - cz) ** 2)
    mask = pipe_mask(nxz, ny, nxz)
    inside = r <= R

    nphase = 50
    stride = period // nphase
    series = np.zeros((nphase, 3, nxz, nxz), np.float32)
    for p in range(nphase):
        prof = amp * womersley_profile(
            np.clip(r / R, 0, 1), alpha, omega * (p + 0.5) * stride
        )
        series[p, 1] = np.where(inside, prof, 0.0)

    bc_kw = dict(rho_mode="extrapolate", u_mode="series",
                 u_series=series, u_series_stride=stride)
    inlet = PlaneBC(mask_value=int(CellType.INLET), axis=1, coord=1,
                    normal=+1, **bc_kw)
    outlet = PlaneBC(mask_value=int(CellType.OUTLET), axis=1,
                     coord=ny - 2, normal=-1, **bc_kw)
    spec = CaseSpec(
        name="womersley_pipe", shape=(nxz, ny, nxz), tau=tau,
        units=UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0),
        mask=mask, boundaries=[inlet, outlet],
        max_steps=6 * period, time_save=period,
    )
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))

    def chunk(f, t0, ln):
        def body(carry, _):
            f, t = carry
            f, rho, u = step(f, t)
            return (f, t + 1), ()
        (f, _), _ = jax.lax.scan(body, (f, t0), xs=None, length=ln)
        return f

    run = jax.jit(chunk, static_argnums=(2,))
    # Spin up 5 periods (slowest Stokes transient decays in ~1 period).
    f = initial_f(cc)
    f = run(f, jnp.int32(0), 5 * period)

    # Sample mid-pipe profiles at 16 phases over the 6th period.
    fluid_mid = np.asarray(cc.fluid)[:, ny // 2, :]
    profs, times = [], []
    t = 5 * period
    for k in range(16):
        f = run(f, jnp.int32(t), period // 16)
        t += period // 16
        _, u = macro_fields(cc, f)
        profs.append(np.asarray(u[1, :, ny // 2, :])[fluid_mid])
        times.append(t)
    sim = np.stack(profs)            # (16, ncells)
    times = np.asarray(times)
    ph = np.exp(1j * omega * times)[:, None]

    def harmonic_fit(sig, ts):
        M = np.stack([np.cos(omega * ts), np.sin(omega * ts)], axis=1)
        coef, *_ = np.linalg.lstsq(M, sig, rcond=None)
        return np.hypot(*coef), np.arctan2(-coef[1], coef[0])

    # 1. Flow-rate transfer vs the imposed waveform (same cell set, the
    # staircase phase active at each sample time).
    q_sim = sim.sum(axis=1)
    # The last step before a sample at time t used the engine's phase
    # index ((t-1) // stride) % T, representing time (idx + 0.5)*stride.
    # The imposed flux lives on the INLET opening footprint (one erosion
    # ring smaller than the mid-pipe fluid disc).
    inlet_fp = np.asarray(mask)[:, 1, :] == CellType.INLET
    idx = (times - 1) // stride
    q_imp = np.array([
        series[int(i) % nphase, 1][inlet_fp].sum() for i in idx
    ])
    t_imp = (idx + 0.5) * stride
    a_s, p_s = harmonic_fit(q_sim, times)
    a_i, p_i = harmonic_fit(q_imp, t_imp)
    # The NEE opening passes ~3.5% more flux than the bare footprint sum
    # (extrapolated ring cells contribute) — a BC discretization effect,
    # not a waveform error; the tight check is the PHASE.
    assert abs(a_s / a_i - 1.0) < 0.06, f"Q amplitude ratio {a_s/a_i:.4f}"
    dphi = (p_s - p_i + np.pi) % (2 * np.pi) - np.pi
    assert abs(dphi) < 0.06, f"Q phase lag {dphi:+.3f} rad"

    # 2. Radial/temporal shape with the wall-position band from the mask:
    # the fluid disc ends at max r over fluid cells; the half-way surface
    # lies within ~[+0.25, +1.25] cells of it on a staircase circle.
    rmax = float(r[fluid_mid].max())
    best = np.inf
    for r_eff in rmax + np.arange(0.25, 1.3, 0.25):
        a_eff = r_eff * np.sqrt(omega / nu)
        lam = 1j**1.5 * a_eff
        U = (1.0 - _j0_complex(lam * np.clip(r / r_eff, 0, 1))
             / _j0_complex(np.asarray(lam)))
        base = U[fluid_mid][None] * ph
        A = np.stack([base.real.ravel(), -base.imag.ravel()], axis=1)
        coef, *_ = np.linalg.lstsq(A, sim.ravel(), rcond=None)
        pred = A @ coef
        err = np.sqrt(np.mean((sim.ravel() - pred) ** 2)) / np.abs(pred).max()
        best = min(best, float(err))
    assert best < 0.05, f"Womersley shape RMS dev {best:.3f} (>5% of peak)"


# --- Taylor-Green vortex: exact viscous decay ---------------------------
# u = U0 ( sin kx cos ky, -cos kx sin ky, 0 ) on a fully periodic box is
# an exact Navier-Stokes solution decaying as e^{-2 nu k^2 t}; fitting
# the kinetic-energy decay rate measures the solver's effective
# viscosity directly (the one anchor that needs NO boundaries at all —
# pure bulk physics, dense-roll periodic wrap).


def test_taylor_green_viscous_decay():
    n, tau, U0 = 32, 0.8, 0.02
    nu = (tau - 0.5) / 3.0
    k = 2.0 * np.pi / n
    x = (np.arange(n) * k)[:, None, None]
    y = (np.arange(n) * k)[None, :, None]
    u0 = np.zeros((3, n, n, n), np.float32)
    u0[0] = U0 * np.sin(x) * np.cos(y)
    u0[1] = -U0 * np.cos(x) * np.sin(y)
    # the consistent pressure field keeps the feq-only init transient
    # small: p = rho cs^2 => drho = 3 dp, dp = (rho U0^2/4)(cos 2kx
    # + cos 2ky)
    rho0 = (1.0 + 3.0 * (U0 * U0 / 4.0)
            * (np.cos(2 * x) + np.cos(2 * y))
            * np.ones((n, n, n))).astype(np.float32)
    spec = CaseSpec(
        name="tgv", shape=(n, n, n), tau=tau,
        units=UnitSystem(CH=1e-4, C_U=1.0, C_rho=1000.0),
        mask=np.full((n, n, n), CellType.FLUID, np.int32),
        boundaries=[], rho0=rho0, u0=u0,
    )
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    ke = {}
    t_marks = (100, 300)
    for t in range(t_marks[-1]):
        f, rho, u = step(f, jnp.int32(t))
        if t + 1 in t_marks:
            ke[t + 1] = float(jnp.sum(u * u))
    rate = -np.log(ke[300] / ke[100]) / (2.0 * (300 - 100))
    nu_measured = rate / (2.0 * k * k)
    assert abs(nu_measured - nu) / nu < 0.01, (
        f"TGV effective viscosity {nu_measured:.5f} vs {nu:.5f}"
    )
