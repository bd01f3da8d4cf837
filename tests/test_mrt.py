"""MRT (multiple-relaxation-time) collision tests — CaseSpec.collision='mrt'.

Beyond-reference: the reference implements SRT-BGK only; its Lectures/
notes cover the MRT family without code. core/mrt.py builds the
d'Humieres-style moment basis by Gram-Schmidt over THIS repo's velocity
ordering and defines m_eq := M feq, which makes the operator's algebra
testable exactly:

  * all rates equal 1/tau      -> BGK (asserted),
  * even/odd parity rates      -> TRT (asserted),
  * shear rows at 1/tau        -> same viscosity as BGK (Poiseuille
                                  error 0.1141 vs BGK 0.1150 at n=24),
and the collide is ONE 19x19 tensordot at HIGHEST precision,
cross-checked here on the dense and sparse paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.mrt import CLASSES, mrt_basis, mrt_matrices
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.step import initial_f, make_step

from backend_parity import assert_sparse_matches_dense


def _dense_run(cc, f0, nsteps):
    step = jax.jit(make_step(cc))
    f = f0
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(f)


def test_basis_orthogonal_with_definite_parity():
    from lbm_jax.core.lattice import D3Q19

    m, d = mrt_basis()
    g = m @ m.T
    assert np.abs(g - np.diag(d)).max() < 1e-9
    opp = D3Q19.OPP
    n_even = 0
    for k in range(19):
        even = np.abs(m[k] - m[k][opp]).max() < 1e-12
        odd = np.abs(m[k] + m[k][opp]).max() < 1e-12
        assert even or odd, f"row {k} ({CLASSES[k]}) has mixed parity"
        n_even += int(even)
    assert n_even == 10  # 10 even + 9 odd rows


def test_matrix_degeneracies():
    """All-equal rates give s(I - P_cons); parity rates give the TRT
    projector combination — both to f64 exactness."""
    m, d = mrt_basis()
    from lbm_jax.core.lattice import D3Q19

    opp = D3Q19.OPP
    tau = 0.7
    s = 1.0 / tau
    k, _ = mrt_matrices(tau, {c: s for c in ("e", "eps", "q", "pi", "m")})
    p_cons = sum(np.outer(m[r], m[r]) / d[r] for r in (0, 3, 5, 7))
    assert np.abs(k - s * (np.eye(19) - p_cons)).max() < 1e-12


def test_mrt_degenerate_matches_bgk():
    tau = 0.55
    s = 1.0 / tau
    cb = compile_case(get_case("lid_driven_cavity", n=16))
    cm = compile_case(get_case(
        "lid_driven_cavity", n=16, collision="mrt",
        mrt_rates={"e": s, "eps": s, "q": s, "pi": s, "m": s}))
    f0 = initial_f(cb)
    fb = _dense_run(cb, f0, 20)
    fm = _dense_run(cm, f0, 20)
    np.testing.assert_allclose(fm, fb, rtol=3e-5, atol=1e-7)


def test_mrt_parity_rates_match_trt():
    tau, lam = 0.55, 0.1875
    taum = 0.5 + lam / (tau - 0.5)
    sp, sm = 1.0 / tau, 1.0 / taum
    ct = compile_case(get_case("lid_driven_cavity", n=16,
                               collision="trt"))
    cm = compile_case(get_case(
        "lid_driven_cavity", n=16, collision="mrt",
        mrt_rates={"e": sp, "eps": sp, "pi": sp, "q": sm, "m": sm}))
    f0 = initial_f(ct)
    ft = _dense_run(ct, f0, 20)
    fm = _dense_run(cm, f0, 20)
    np.testing.assert_allclose(fm, ft, rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("case_name,kwargs", [
    ("lid_driven_cavity", dict(n=16)),
    ("coronary", dict(shape=(24, 20, 32), radius=4)),
])
def test_mrt_sparse_case_matches_dense(case_name, kwargs):
    assert_sparse_matches_dense(dataclasses.replace(
        get_case(case_name, **kwargs), collision="mrt"))


def test_mrt_sparse_matches_dense():
    from lbm_jax.engine.sparse import (
        compile_sparse,
        initial_f_sparse,
        make_sparse_step,
        scatter_dense,
    )

    spec = dataclasses.replace(get_case("poiseuille", n=16),
                               collision="mrt")
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


def test_mrt_with_force_dense_vs_sparse():
    """MRT + Guo force composes via the moment-space prefactor KF on
    both backends."""
    from lbm_jax.engine.sparse import (
        compile_sparse,
        initial_f_sparse,
        make_sparse_step,
        scatter_dense,
    )

    spec = dataclasses.replace(get_case("poiseuille", n=16),
                               collision="mrt", force=(0.0, 1e-5, 0.0))
    sc = compile_sparse(spec)
    cc = compile_case(spec)
    sstep = jax.jit(make_sparse_step(sc))
    fs = initial_f_sparse(sc)
    for t in range(4):
        fs, _, _ = sstep(fs, jnp.int32(t))
    fd = np.asarray(scatter_dense(sc, fs))
    f_ref = _dense_run(cc, initial_f(cc), 4)
    assert np.isfinite(f_ref).all()
    live = np.asarray(sc.index) >= 0
    np.testing.assert_allclose(
        fd[:, live], f_ref[:, live], rtol=3e-6, atol=1e-7
    )


def test_mrt_force_auto_backend_runs_dense():
    """backend='auto' takes MRT + force on the dense step, with no
    fallback path in between."""
    from lbm_jax.engine.runner import Simulation

    spec = dataclasses.replace(
        get_case("lid_driven_cavity", n=16), collision="mrt",
        force=(0.0, 0.0, 1e-5))
    sim = Simulation(spec)
    assert sim.backend == "xla"
    sim.run(max_steps=4, time_save=4, verbose=False)
    assert np.isfinite(np.asarray(sim.f)).all()


def test_mrt_mass_conservation_closed_box():
    """K annihilates the conserved rows exactly (rate 0), so mass is
    conserved to the same rounding as BGK."""
    case = get_case("lid_driven_cavity", n=16, u_lid_phys=0.0,
                    collision="mrt")
    cc = compile_case(case)
    f0 = initial_f(cc)
    fluid = np.asarray(cc.fluid)
    m0 = float(np.asarray(f0).sum(axis=0)[fluid].sum())
    f = _dense_run(cc, f0, 20)
    m1 = float(f.sum(axis=0)[fluid].sum())
    assert abs(m1 - m0) / m0 < 1e-6


def test_mrt_viscosity_matches_bgk_on_poiseuille():
    """Shear rows relax at 1/tau, so the converged parabola carries the
    same viscosity (and the same discretization error) as BGK:
    measured rel L2 0.1141 (MRT) vs 0.1150 (BGK) at n=24."""
    from lbm_jax.cases.poiseuille import analytic_profile
    from lbm_jax.engine.runner import Simulation

    errs = {}
    for coll in ("bgk", "mrt"):
        n = 24
        sim = Simulation(get_case("poiseuille", n=n, max_steps=6000,
                                  time_save=250, collision=coll))
        res = sim.run(verbose=False)
        assert res.converged
        rho, u = sim.macro()
        uy = np.asarray(u)[1, :, n // 2, :]
        fl = np.asarray(sim.cc.fluid)[:, n // 2, :]
        exact = analytic_profile(n)
        errs[coll] = float(np.linalg.norm((uy - exact)[fl])
                           / np.linalg.norm(exact[fl]))
    assert abs(errs["mrt"] - errs["bgk"]) < 0.2 * errs["bgk"], errs
