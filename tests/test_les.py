"""Smagorinsky LES closure tests — CaseSpec.smagorinsky_cs.

Beyond-reference: the reference targets laminar flow only (Re = 222,
README.md). The standard closed-form Smagorinsky eddy viscosity
(engine/step.les_tau_eff): per-cell
tau_eff = (tau + sqrt(tau^2 + 18 Cs^2 P / rho)) / 2, with P the norm of
the non-equilibrium momentum flux Pi_ab = sum_i e_ia e_ib f_neq_i — so
nu_eff = nu0 + (Cs D)^2 |S| with no extra state carried.

Covered:
  * Cs -> 0 degenerates to BGK (sqrt(tau^2) folds back),
  * cross-backend equivalence (dense / sparse, incl. the coronary
    z-plane fixup),
  * the stability payoff: three under-resolved high-Re cavity configs
    where BOTH plain BGK and MRT blow up within 250 steps run stably
    under LES (the eddy viscosity activates exactly at the sharp
    gradients that kill the bare operators),
  * laminar invariance: on the resolved Poiseuille flow |S| is small,
    so the LES solution stays within a few percent of BGK's error.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.step import initial_f, make_step

from backend_parity import assert_sparse_matches_dense


def _dense_run(cc, f0, nsteps):
    step = jax.jit(make_step(cc))
    f = f0
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(f)


def test_les_cs_zero_limit_matches_bgk():
    """Tiny Cs: tau_eff -> tau and the update folds back to BGK."""
    cb = compile_case(get_case("lid_driven_cavity", n=16))
    cl = compile_case(dataclasses.replace(
        get_case("lid_driven_cavity", n=16), smagorinsky_cs=1e-6))
    f0 = initial_f(cb)
    fb = _dense_run(cb, f0, 20)
    fl = _dense_run(cl, f0, 20)
    np.testing.assert_allclose(fl, fb, rtol=3e-5, atol=1e-7)


def test_les_changes_the_answer():
    cb = compile_case(get_case("lid_driven_cavity", n=16))
    cl = compile_case(dataclasses.replace(
        get_case("lid_driven_cavity", n=16), smagorinsky_cs=0.17))
    f0 = initial_f(cb)
    fb = _dense_run(cb, f0, 20)
    fl = _dense_run(cl, f0, 20)
    assert np.isfinite(fl).all()
    assert np.abs(fl - fb).max() > 1e-7


@pytest.mark.parametrize("case_name,kwargs", [
    ("lid_driven_cavity", dict(n=16)),
    ("coronary", dict(shape=(24, 20, 32), radius=4)),
])
def test_les_sparse_case_matches_dense(case_name, kwargs):
    assert_sparse_matches_dense(dataclasses.replace(
        get_case(case_name, **kwargs), smagorinsky_cs=0.17))


def test_les_sparse_matches_dense():
    from lbm_jax.engine.sparse import (
        compile_sparse,
        initial_f_sparse,
        make_sparse_step,
        scatter_dense,
    )

    spec = dataclasses.replace(get_case("poiseuille", n=16),
                               smagorinsky_cs=0.17)
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


def test_les_constraint_asserts():
    with pytest.raises(AssertionError):  # MRT moment rates not wired
        get_case("lid_driven_cavity", n=16, collision="mrt",
                 smagorinsky_cs=0.17)
    with pytest.raises(ValueError):  # exclusive per-cell tau closures
        get_case("lid_driven_cavity", n=16, smagorinsky_cs=0.17,
                 rheology={"model": "power_law", "K": 0.1, "n": 0.7})


def test_les_trt_degenerates_to_plain_trt_at_tiny_cs():
    """LES + TRT (r5: constant-Lambda odd rate, closure_tau_minus):
    with Cs -> 0 the closure's tau_eff -> tau everywhere, the
    constant-Lambda odd rate folds back to the base tau_minus, and the
    composition must reproduce PLAIN TRT at the same magic Lambda.
    (Note the composition does NOT degenerate to LES+BGK at
    magic_lambda=(tau-1/2)^2: holding Lambda constant makes the
    per-cell odd rate differ from tau_eff wherever the closure is
    active — that is the point of the pairing.)"""
    spec_p = get_case("lid_driven_cavity", n=16, collision="trt",
                      magic_lambda=0.1875)
    spec_c = get_case("lid_driven_cavity", n=16, collision="trt",
                      magic_lambda=0.1875, smagorinsky_cs=1e-6)
    ccp = compile_case(spec_p)
    ccc = compile_case(spec_c)
    fp = _dense_run(ccp, initial_f(ccp), 40)
    fc = _dense_run(ccc, initial_f(ccc), 40)
    np.testing.assert_allclose(fc, fp, rtol=1e-5, atol=1e-7)


def test_les_trt_differs_and_stays_finite():
    """At the standard Lambda = 3/16 the odd rate differs per cell:
    the composition is a distinct, finite operator (and the sparse
    backend agrees with the dense one through it)."""
    import dataclasses

    from lbm_jax.engine.runner import Simulation

    spec = get_case("poiseuille", n=16, collision="trt",
                    magic_lambda=0.1875)
    spec = dataclasses.replace(spec, smagorinsky_cs=0.17)
    spec.__post_init__()
    sim_d = Simulation(spec, backend="xla")
    sim_s = Simulation(spec, backend="sparse")
    for s in (sim_d, sim_s):
        s.run(max_steps=40, time_save=20, verbose=False)
    fd = np.asarray(sim_d.f_standard())
    assert np.isfinite(fd).all()
    live = np.asarray(spec.mask) != 0
    np.testing.assert_allclose(
        np.asarray(sim_s.f_standard())[:, live], fd[:, live],
        rtol=3e-5, atol=1e-7)
    # differs from plain TRT (the closure is live)
    plain = Simulation(get_case("poiseuille", n=16, collision="trt",
                                magic_lambda=0.1875), backend="xla")
    plain.run(max_steps=40, time_save=20, verbose=False)
    assert np.abs(fd - np.asarray(plain.f_standard())).max() > 1e-7


def test_les_trt_buoyancy_composes():
    """LES + TRT + Boussinesq buoyancy (the stabilized high-Ra
    pairing): the dense thermal route runs the triple composition with
    the per-cell Guo prefactors split by parity (guo_source
    tau_local_minus) and stays finite through a convective transient."""
    import dataclasses

    from lbm_jax.cases.thermal import rayleigh_benard
    from lbm_jax.engine.thermal import BuoyantTransport

    spec, kwargs, info = rayleigh_benard(nx=16, ny=1, nz=10, ra=3000.0)
    spec = dataclasses.replace(spec, collision="trt",
                               magic_lambda=0.1875,
                               smagorinsky_cs=0.12)
    spec.__post_init__()
    bt = BuoyantTransport(spec, **kwargs)
    e = bt.run(120, record_energy=True)
    assert np.isfinite(e).all() and e[-1] > 0
    assert np.isfinite(np.asarray(bt.concentration())).all()


def _blowup_step(cc, steps, check_every=250):
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(steps):
        f, rho, u = step(f, jnp.int32(t))
        if (t + 1) % check_every == 0:
            if not np.isfinite(np.asarray(f)).all():
                return t + 1
    return None if np.isfinite(np.asarray(f)).all() else steps


def test_les_stabilizes_underresolved_cavity():
    """The feature's payoff: at tau = 0.505, lid Ma = 0.15 on 16^3
    (Re ~ 1100 at 12 fluid cells — far under-resolved), plain BGK AND
    default MRT both go NaN within 250 steps; Cs = 0.17 LES runs 2500
    steps finite (the eddy viscosity activates at the corner
    singularity's gradients)."""
    kw = dict(n=16, tau=0.505, u_lid_phys=0.15 * 2.4705)
    assert _blowup_step(compile_case(get_case(
        "lid_driven_cavity", **kw)), 500) is not None
    assert _blowup_step(compile_case(get_case(
        "lid_driven_cavity", collision="mrt", **kw)), 500) is not None
    cc = compile_case(dataclasses.replace(
        get_case("lid_driven_cavity", **kw), smagorinsky_cs=0.17))
    assert _blowup_step(cc, 2500) is None


def test_les_laminar_invariance_poiseuille():
    """On the resolved laminar pipe |S| ~ u/R is tiny, so the LES error
    vs the analytic parabola stays within a few percent of BGK's."""
    from lbm_jax.cases.poiseuille import analytic_profile
    from lbm_jax.engine.runner import Simulation

    errs = {}
    for cs in (None, 0.17):
        n = 24
        sim = Simulation(get_case("poiseuille", n=n, max_steps=6000,
                                  time_save=250, smagorinsky_cs=cs))
        res = sim.run(verbose=False)
        assert res.converged
        rho, u = sim.macro()
        uy = np.asarray(u)[1, :, n // 2, :]
        fl = np.asarray(sim.cc.fluid)[:, n // 2, :]
        exact = analytic_profile(n)
        errs[cs] = float(np.linalg.norm((uy - exact)[fl])
                         / np.linalg.norm(exact[fl]))
    assert errs[0.17] < 1.2 * errs[None], errs


@pytest.mark.parametrize("feature", ["les", "rheo"])
def test_closure_trt_sparse_matches_dense(feature):
    """closure + TRT: the constant-Lambda parity split (per-cell even
    rate tau_eff, odd via closure_tau_minus) — multi-step whole-box
    agreement of the sparse route with the dense one, incl. the NEE
    lid rows."""
    kw = ({"smagorinsky_cs": 0.17} if feature == "les" else
          {"rheology": {"model": "power_law", "K": 0.02, "n": 0.7}})
    spec = get_case("lid_driven_cavity", n=16, collision="trt",
                    magic_lambda=0.1875, **kw)
    assert_sparse_matches_dense(spec, nsteps=30, rtol=3e-5)
