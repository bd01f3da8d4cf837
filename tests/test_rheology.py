"""Non-Newtonian (generalized-Newtonian) rheology tests —
CaseSpec.rheology (core/rheology.py).

Beyond-reference: every reference solver is Newtonian with a constant
compiled-in tau (e.g. /root/reference/coronary_cfd/coronary.cu:24),
while blood is shear-thinning. The closure reuses the LES machinery:
P = sqrt(2 Pi:Pi) from the non-equilibrium momentum flux gives the
local shear rate gamma_dot = 3 P / (2 rho tau_eff), and
tau_eff = 1/2 + 3 nu(gamma_dot) closes as a per-cell Picard fixed
point (power_law / carreau / carreau_yasuda).

Covered:
  * closure validation (exclusivity with LES, unknown models/keys,
    collision constraint),
  * the Picard fixed point actually satisfies
    te = 1/2 + 3 nu(1.5 P / (rho te)) off the clip bounds,
  * Newtonian limits fold back to BGK (carreau nu0 = nu_inf = nu(tau);
    power_law n = 1, K = nu(tau)),
  * the physics anchor: gravity-driven plane channel of a power-law
    fluid matches the analytic profile
        u(x) = n/(n+1) (F/K)^(1/n) [c^((n+1)/n) - |x-c|^((n+1)/n)]
    — this runs force + closure together, so it also validates the
    variable-rate Guo prefactor (1 - 1/(2 tau_eff)),
  * cross-backend equivalence (dense / sparse; the sharded paths gain
    carreau rows in test_parallel.py),
  * backend='auto' runs closure + force on the dense step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.rheology import (
    normalize_closure,
    nu_of_gamma,
    tau_eff_from_p,
)
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.engine.step import initial_f, make_step
from lbm_jax.geometry.mask import CellType

from backend_parity import assert_sparse_matches_dense

_UNITS = UnitSystem(CH=1e-4, C_U=1.0, C_rho=1000.0)

CARREAU = {"model": "carreau", "nu0": 0.3, "nu_inf": 0.02,
           "lam": 3000.0, "n": 0.5}


def _dense_run(cc, f0, nsteps):
    step = jax.jit(make_step(cc))
    f = f0
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(f)


# ---------------------------------------------------------------------
# Closure plumbing


def test_closure_validation():
    with pytest.raises(ValueError):  # exclusive with LES
        normalize_closure(0.17, {"model": "power_law", "K": 0.1,
                                 "n": 0.7})
    with pytest.raises(ValueError):  # unknown model
        normalize_closure(None, {"model": "bingham"})
    with pytest.raises(ValueError):  # missing required parameter
        normalize_closure(None, {"model": "casson"})
    with pytest.raises(AssertionError):  # unknown key
        normalize_closure(None, {"model": "power_law", "K": 0.1,
                                 "n": 0.7, "mu": 1.0})
    with pytest.raises(AssertionError):  # bad bounds
        normalize_closure(None, {"model": "power_law", "K": 0.1,
                                 "n": 0.7, "tau_bounds": (0.4, 2.0)})
    with pytest.raises(AssertionError):  # MRT moment rates not wired
        get_case("lid_driven_cavity", n=16, collision="mrt",
                 rheology={"model": "power_law", "K": 0.1, "n": 0.7})
    # r5: closures compose with TRT (constant-Lambda odd rate)
    get_case("lid_driven_cavity", n=16, collision="trt",
             rheology={"model": "power_law", "K": 0.1, "n": 0.7})
    # defaults materialize into the static tuple
    assert normalize_closure(None, {"model": "carreau_yasuda",
                                    "nu0": 0.1, "nu_inf": 0.01,
                                    "lam": 10.0, "n": 0.4,
                                    "a": 1.25})[5] == 1.25


@pytest.mark.parametrize("rheo", [
    {"model": "power_law", "K": 0.02, "n": 0.7},
    CARREAU,
    {"model": "carreau_yasuda", "nu0": 0.3, "nu_inf": 0.02,
     "lam": 3000.0, "n": 0.5, "a": 1.25},
    {"model": "casson", "nu_c": 0.02, "tau_y": 1e-5},
])
def test_picard_fixed_point_satisfies_closure(rheo):
    """tau_eff from the unrolled Picard iteration satisfies the
    implicit equation te = 1/2 + 3 nu(1.5 P/(rho te)) wherever the
    solution is interior to the clip bounds (iters=16 here: also
    exercises the 'iters' knob; the default 8 leaves ~1e-3 residual
    on the slowest-contracting samples, fine for the physics)."""
    cl = normalize_closure(None, {**rheo, "iters": 16})
    lo, hi = cl[-3], cl[-2]
    rng = np.random.default_rng(0)
    p = jnp.asarray(10.0 ** rng.uniform(-8, -2, 64), jnp.float32)
    inv_rho = jnp.asarray(1.0 / rng.uniform(0.9, 1.1, 64), jnp.float32)
    te = np.asarray(tau_eff_from_p(p, inv_rho, 0.8, cl), np.float64)
    gamma = 1.5 * np.asarray(p, np.float64) * np.asarray(
        inv_rho, np.float64) / te
    resid = te - (0.5 + 3.0 * nu_of_gamma(gamma, cl))
    interior = (te > lo * 1.01) & (te < hi * 0.99)
    assert interior.any()
    np.testing.assert_allclose(resid[interior], 0.0, atol=2e-3)


def test_newtonian_limits_match_bgk():
    """carreau with nu0 = nu_inf = nu(tau) and power_law with n = 1,
    K = nu(tau) are both exactly Newtonian at the case tau — the
    closure folds back to plain BGK."""
    spec0 = get_case("lid_driven_cavity", n=16)
    nu = (spec0.tau - 0.5) / 3.0
    f0 = initial_f(compile_case(spec0))
    fb = _dense_run(compile_case(spec0), f0, 20)
    for rheo in (
        {"model": "carreau", "nu0": nu, "nu_inf": nu, "lam": 50.0,
         "n": 0.4},
        {"model": "power_law", "K": nu, "n": 1.0},
    ):
        fr = _dense_run(compile_case(dataclasses.replace(
            spec0, rheology=rheo)), f0, 20)
        np.testing.assert_allclose(fr, fb, rtol=3e-5, atol=1e-7)


def test_shear_thinning_changes_the_answer():
    spec0 = get_case("lid_driven_cavity", n=16)
    f0 = initial_f(compile_case(spec0))
    fb = _dense_run(compile_case(spec0), f0, 20)
    fr = _dense_run(compile_case(dataclasses.replace(
        spec0, rheology=dict(CARREAU))), f0, 20)
    assert np.isfinite(fr).all()
    assert np.abs(fr - fb).max() > 1e-7


# ---------------------------------------------------------------------
# Physics: gravity-driven plane channel of a power-law fluid (the
# analytic generalized-Newtonian benchmark; runs force + closure
# together => validates the variable-rate Guo prefactor too).


def test_power_law_channel_profile():
    nx, ny, nz = 12, 8, 8
    n_exp, K, Fy = 0.7, 0.01, 1e-5
    geo = np.zeros((nx, ny, nz), np.int32)
    geo[0, :, :] = CellType.WALL
    geo[nx - 1, :, :] = CellType.WALL
    geo[1:nx - 1, :, :] = CellType.FLUID
    spec = CaseSpec(
        name="plaw_chan", shape=(nx, ny, nz), tau=0.8, units=_UNITS,
        mask=geo, boundaries=[], force=(0.0, Fy, 0.0),
        rheology={"model": "power_law", "K": K, "n": n_exp},
    )
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(6000):
        f, rho, u = step(f, jnp.int32(t))
    uy = np.asarray(u)[1, :, ny // 2, nz // 2]
    W = nx - 2.0
    c = W / 2.0
    xi = np.arange(nx) - 0.5  # walls at xi = 0 and xi = W (halfway BB)
    ex = (n_exp + 1.0) / n_exp
    exact = (n_exp / (n_exp + 1.0)) * (Fy / K) ** (1.0 / n_exp) * (
        c ** ex - np.abs(xi - c) ** ex)
    m = np.asarray(cc.fluid)[:, ny // 2, nz // 2]
    err = float(np.linalg.norm((uy - exact)[m])
                / np.linalg.norm(exact[m]))
    assert err < 0.03, f"power-law channel error {err:.2e}"
    # and it is genuinely non-parabolic: the Newtonian fit at the same
    # u_max is measurably wrong (the n=0.7 profile is flatter)
    para = exact.max() * (1.0 - ((xi - c) / c) ** 2)
    err_para = float(np.linalg.norm((uy - para)[m])
                     / np.linalg.norm(para[m]))
    assert err_para > 3 * err, (err, err_para)


# ---------------------------------------------------------------------
# Cross-backend equivalence (mirrors test_les.py)


@pytest.mark.parametrize("case_name,kwargs", [
    ("lid_driven_cavity", dict(n=16)),
    ("coronary", dict(shape=(24, 20, 32), radius=4)),
])
def test_rheology_sparse_case_matches_dense(case_name, kwargs):
    assert_sparse_matches_dense(dataclasses.replace(
        get_case(case_name, **kwargs), rheology=dict(CARREAU)))


def test_rheology_sparse_matches_dense():
    from lbm_jax.engine.sparse import (
        compile_sparse,
        initial_f_sparse,
        make_sparse_step,
        scatter_dense,
    )

    spec = dataclasses.replace(get_case("poiseuille", n=16),
                               rheology=dict(CARREAU))
    sc = compile_sparse(spec)
    cc = compile_case(spec)
    sstep = jax.jit(make_sparse_step(sc))
    fs = initial_f_sparse(sc)
    for t in range(4):
        fs, _, _ = sstep(fs, jnp.int32(t))
    fd = np.asarray(scatter_dense(sc, fs))
    f_ref = _dense_run(cc, initial_f(cc), 4)
    live = np.asarray(sc.index) >= 0
    np.testing.assert_allclose(
        fd[:, live], f_ref[:, live], rtol=3e-6, atol=1e-7
    )


def test_closure_plus_force_auto_backend_runs_dense():
    from lbm_jax.engine.runner import Simulation

    spec = get_case("gravity_channel", n=16, nz=16, fz=1e-5,
                    rheology={"model": "power_law", "K": 0.05,
                              "n": 0.7}, max_steps=50, time_save=50)
    sim = Simulation(spec)  # backend='auto'
    assert sim.backend == "xla"
    sim.run(verbose=False)
    _, u = sim.macro()
    assert np.isfinite(np.asarray(u)).all()


# ---------------------------------------------------------------------
# Physiological blood model (core/rheology.carreau_blood)


def test_carreau_blood_constructor():
    """Cho & Kensey constants through the coronary unit system: exact
    conversion values, and the resulting tau_eff band is physiological
    (0.56..1.48 over the resolved shear-rate decades — the transition
    lands in-band, so the correction is active, not decorative)."""
    from lbm_jax.core.rheology import carreau_blood

    u = UnitSystem(CH=0.0000655737, C_U=2.4705, C_rho=1060.0)
    d = carreau_blood(u)
    nu_scale = u.CH * u.C_U
    np.testing.assert_allclose(d["nu0"], 0.056 / 1060.0 / nu_scale)
    np.testing.assert_allclose(d["nu_inf"], 0.00345 / 1060.0 / nu_scale)
    np.testing.assert_allclose(d["lam"], 3.313 / u.C_T)
    cl = normalize_closure(None, d)
    taus = [float(0.5 + 3.0 * nu_of_gamma(g, cl))
            for g in (1e-7, 1e-5, 1e-3)]
    assert 1.4 < taus[0] < 1.5 and 0.55 < taus[2] < 0.65
    # pass-through of the tuning keys
    assert normalize_closure(
        None, carreau_blood(u, iters=4))[-1] == 4


def test_coronary_runs_on_blood_rheology():
    """The flagship composition: the coronary tree case under the
    physiological Carreau model (in ITS OWN unit system) runs finite
    and measurably non-Newtonian."""
    from lbm_jax.core.rheology import carreau_blood

    spec_n = get_case("coronary", shape=(24, 20, 32), radius=4)
    spec_b = get_case("coronary", shape=(24, 20, 32), radius=4,
                      rheology=carreau_blood(spec_n.units))
    f0 = initial_f(compile_case(spec_n))
    fn = _dense_run(compile_case(spec_n), f0, 30)
    fb = _dense_run(compile_case(spec_b), f0, 30)
    assert np.isfinite(fb).all()
    assert np.abs(fb - fn).max() > 1e-7


def test_casson_limits_and_plug():
    """tau_y = 0 is exactly Newtonian at nu_c (folds back to BGK), and
    at low shear the plug core rides the te_hi clip — the standard
    yield-stress regularization."""
    spec0 = get_case("lid_driven_cavity", n=16)
    nu = (spec0.tau - 0.5) / 3.0
    f0 = initial_f(compile_case(spec0))
    fb = _dense_run(compile_case(spec0), f0, 20)
    fc = _dense_run(compile_case(dataclasses.replace(
        spec0, rheology={"model": "casson", "nu_c": nu,
                         "tau_y": 0.0})), f0, 20)
    np.testing.assert_allclose(fc, fb, rtol=3e-5, atol=1e-7)
    # plug: tiny P => te at the hi clip
    cl = normalize_closure(None, {"model": "casson", "nu_c": 0.02,
                                  "tau_y": 1e-4})
    te = tau_eff_from_p(jnp.asarray([1e-9], jnp.float32),
                        jnp.asarray([1.0], jnp.float32), 0.8, cl)
    np.testing.assert_allclose(np.asarray(te), cl[-2], rtol=1e-5)
