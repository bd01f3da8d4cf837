"""Multi-chip decomposition tests on the 8-device virtual CPU mesh
(SURVEY.md section 4: sharded run must match the single-device run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.step import initial_f, make_step
from lbm_jax.parallel.halo import make_halo_step
from lbm_jax.parallel.mesh import (
    free_axis,
    lattice_mesh,
    lattice_sharding,
    shard_case,
)

pytestmark = pytest.mark.multichip

_CARREAU = {"model": "carreau", "nu0": 0.3, "nu_inf": 0.02, "lam": 3000.0,
            "n": 0.5}
_WK4 = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3), (1e-4, 5e3, 4e-3),
        (1e-4, 5e3, 8e-3)]


def _reference_run(cc, nsteps):
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(f), np.asarray(rho), np.asarray(u)


@pytest.mark.parametrize("case_name,kwargs", [
    ("lid_driven_cavity", dict(n=16)),
    ("poiseuille", dict(n=16)),
    ("poiseuille", dict(n=16, collision="trt")),
    ("curved_vessel", dict(n=32, nphase=4, period_steps=8)),
])
def test_gspmd_sharded_matches_single_device(case_name, kwargs):
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    spec = get_case(case_name, **kwargs)
    cc = compile_case(spec)
    nsteps = 7
    f_ref, rho_ref, u_ref = _reference_run(cc, nsteps)

    axis = free_axis(spec)
    mesh = lattice_mesh()
    cc_sh = shard_case(cc, mesh, axis)
    shard = lattice_sharding(axis=axis, mesh=mesh, leading=1)
    step = jax.jit(lambda cc, f, t: make_step(cc)(f, t))
    f = jax.device_put(initial_f(cc), shard)
    for t in range(nsteps):
        f, rho, u = step(cc_sh, f, jnp.int32(t))
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=3e-6, atol=1e-6)


@pytest.mark.parametrize("case_name,kwargs", [
    ("lid_driven_cavity", dict(n=16)),
    ("poiseuille", dict(n=16)),
    ("poiseuille", dict(n=16, collision="trt")),
    ("poiseuille", dict(n=16, force=(0.0, 1e-5, 0.0))),
    ("lid_driven_cavity", dict(n=16, lid="bounceback")),
    ("poiseuille", dict(n=16, collision="mrt")),
    ("poiseuille", dict(n=16, smagorinsky_cs=0.17)),
    ("poiseuille", dict(n=16, rheology={"model": "carreau", "nu0": 0.3,
                            "nu_inf": 0.02, "lam": 3000.0, "n": 0.5})),
    ("coronary", dict(shape=(48, 24, 40), radius=5, collision="trt")),
    ("coronary", dict(shape=(48, 24, 40), radius=5,
                      force=(0.0, 0.0, -1e-5))),
    ("lid_driven_cavity", dict(n=16, collision="mrt")),
    ("curved_vessel", dict(n=32, nphase=4, period_steps=8)),
    ("coronary", dict(shape=(48, 24, 40), radius=5, pulsatile=(4, 8),
                      rheology=_CARREAU)),
])
def test_halo_exchange_matches_single_device(case_name, kwargs):
    spec = get_case(case_name, **kwargs)
    cc = compile_case(spec)
    nsteps = 7
    f_ref, rho_ref, u_ref = _reference_run(cc, nsteps)

    axis = free_axis(spec)
    mesh = lattice_mesh()
    cc_sh = shard_case(cc, mesh, axis)
    step = jax.jit(lambda cc, f, t: make_halo_step(cc, mesh, axis)(f, t))
    shard = lattice_sharding(axis=axis, mesh=mesh, leading=1)
    f = jax.device_put(initial_f(cc), shard)
    for t in range(nsteps):
        f, rho, u = step(cc_sh, f, jnp.int32(t))
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=3e-6, atol=1e-7)


def test_coronary_shards_on_y():
    spec = get_case("coronary", shape=(48, 32, 40), radius=5)
    assert free_axis(spec) == 1
    cc = compile_case(spec)
    nsteps = 4
    f_ref, _, _ = _reference_run(cc, nsteps)
    mesh = lattice_mesh()
    cc_sh = shard_case(cc, mesh, 1)
    step = jax.jit(lambda cc, f, t: make_halo_step(cc, mesh, 1)(f, t))
    f = jax.device_put(initial_f(cc), lattice_sharding(axis=1, mesh=mesh, leading=1))
    for t in range(nsteps):
        f, rho, u = step(cc_sh, f, jnp.int32(t))
    np.testing.assert_allclose(np.asarray(f), f_ref, rtol=3e-6, atol=1e-7)


def test_gspmd_convergence_horizon():
    """600-step GSPMD-sharded-vs-dense equivalence (VERDICT r3 weak-#1):
    fields AND the per-step velsum series, long enough for information
    to cross every shard boundary many times."""
    spec = get_case("lid_driven_cavity", n=16)
    cc = compile_case(spec)
    nsteps = 600
    step_d = jax.jit(make_step(cc))
    fluid = np.asarray(cc.fluid)
    f = initial_f(cc)
    ref_series = np.empty(nsteps)
    for t in range(nsteps):
        f, rho, u = step_d(f, jnp.int32(t))
        ref_series[t] = float(
            np.sum(np.sqrt(np.sum(np.asarray(u) ** 2, axis=0))[fluid]))
    f_ref = np.asarray(f)

    axis = free_axis(spec)
    mesh = lattice_mesh()
    cc_sh = shard_case(cc, mesh, axis)
    step = jax.jit(lambda cc, f, t: make_step(cc)(f, t))
    fs = jax.device_put(initial_f(cc),
                        lattice_sharding(axis=axis, mesh=mesh, leading=1))
    series = np.empty(nsteps)
    for t in range(nsteps):
        fs, rho, u = step(cc_sh, fs, jnp.int32(t))
        series[t] = float(
            np.sum(np.sqrt(np.sum(np.asarray(u) ** 2, axis=0))[fluid]))
    np.testing.assert_allclose(np.asarray(fs), f_ref, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(series, ref_series, rtol=1e-5)


@pytest.mark.parametrize("case_name,kwargs,axis", [
    ("lid_driven_cavity", dict(n=16, lid="bounceback"), 0),
    ("coronary", dict(shape=(48, 24, 40), radius=5, curved=True,
                      windkessel=_WK4), 1),
], ids=["moving-lid", "bouzidi-windkessel"])
def test_shard_case_layout(case_name, kwargs, axis):
    """shard_case splits EVERY per-cell array of the case along the
    shard axis (moving-wall and Bouzidi link arrays included) and
    replicates the BC planes — one layout for the GSPMD and halo
    paths."""
    spec = get_case(case_name, **kwargs)
    cc = compile_case(spec)
    per_cell = [a for a in ("fluid", "nbr_wall", "rho0", "u0",
                            "nbr_moving", "link_q")
                if getattr(cc, a) is not None]
    assert ("nbr_moving" in per_cell) == (case_name != "coronary")
    assert ("link_q" in per_cell) == (case_name == "coronary")
    sh = shard_case(cc, lattice_mesh(), axis)
    for name in per_cell:
        a = getattr(sh, name)
        lead = a.ndim - 3
        assert a.sharding.spec[lead + axis] == "d", name
        assert len(a.sharding.device_set) == 8, name
        np.testing.assert_array_equal(np.asarray(a),
                                      np.asarray(getattr(cc, name)))
    for b in sh.bcs:
        assert b.valid.sharding.is_fully_replicated
    assert sh.spec is spec and sh.tau == cc.tau


def test_halo_step_rejects_bc_on_shard_axis():
    spec = get_case("poiseuille", n=16)
    cc = compile_case(spec)
    with pytest.raises(ValueError):
        make_halo_step(cc, lattice_mesh(), shard_axis=1)


@pytest.mark.parametrize("case_name,kwargs", [
    ("coronary", dict(shape=(48, 24, 40), radius=5)),
    ("lid_driven_cavity", dict(n=16, u_lid_phys=0.0,
                               force=(1e-5, 2e-5, -1e-5))),
    ("poiseuille", dict(n=16, collision="trt")),
    ("lid_driven_cavity", dict(n=16, collision="mrt")),
    ("poiseuille", dict(n=16, smagorinsky_cs=0.17)),
    ("poiseuille", dict(n=16, rheology=_CARREAU)),
    ("lid_driven_cavity", dict(n=16, lid="bounceback")),
    ("curved_vessel", dict(n=32, nphase=4, period_steps=8)),
    ("coronary", dict(shape=(48, 24, 40), radius=5, windkessel=_WK4)),
    ("coronary", dict(shape=(48, 24, 40), radius=5, windkessel=_WK4,
                      pulsatile=(4, 8), rheology=_CARREAU)),
], ids=["coronary-y-shard", "force", "trt", "mrt", "les", "carreau",
        "moving-lid", "series-inlet", "windkessel", "clinical"])
def test_runner_gspmd_matches_single_device(case_name, kwargs):
    """Simulation(mesh=) — the runner's GSPMD path, with the case's
    arrays laid out on the mesh as jit arguments — against the
    single-device dense run, state and windkessel carry."""
    from backend_parity import assert_matches_dense

    from lbm_jax.engine.runner import Simulation

    spec = get_case(case_name, **kwargs)
    assert len(Simulation(spec, mesh=lattice_mesh()).f.sharding
               .device_set) == 8
    assert_matches_dense(spec, nsteps=6, mesh=lattice_mesh())
