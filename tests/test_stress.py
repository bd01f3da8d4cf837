"""Deviatoric stress tensor + wall shear stress tests
(engine/stress.py).

Beyond-reference: the reference outputs velocity and pressure only
(/root/reference/coronary_cfd/coronary.cu:948-1011); WSS — the central
clinical quantity of coronary hemodynamics — is never computed there.
Anchors, all against exact momentum-balance solutions:

  * Couette: sigma_xy = rho nu U/W constant across the gap (the linear
    profile is exact for half-way BB, so the stress is too),
  * gravity-driven plane channel: sigma_xy(x) = rho F (c - x) linear,
    with the Guo (u F + F u)/2 second-moment correction active,
  * power-law channel: the WALL STRESS is set by momentum balance
    ALONE — rho F (c - x) independent of the rheology model — so the
    per-cell closure prefactor -(1 - 1/(2 tau_eff)) must reproduce the
    same sigma_xy as the Newtonian run even though tau_eff varies
    across the gap by an order of magnitude,
  * WSS = tangential traction magnitude at the near-wall cell center
    (half a cell off the wall plane: F (c - 1/2) in the channel),
  * voxel wall normals (flat plane / edge cells),
  * backend equivalence of Simulation.wss() (xla vs sparse vs GSPMD).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.engine.step import initial_f, make_step
from lbm_jax.engine.stress import stress_fields, wall_normals, wss_field
from lbm_jax.geometry.mask import CellType

_UNITS = UnitSystem(CH=1e-4, C_U=1.0, C_rho=1000.0)


def _run(cc, nsteps):
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(nsteps):
        f, _, _ = step(f, jnp.int32(t))
    return f, nsteps


def _channel_spec(nx=12, tau=0.8, Fy=1e-5, **kw):
    ny = nz = 8
    geo = np.zeros((nx, ny, nz), np.int32)
    geo[0, :, :] = CellType.WALL
    geo[nx - 1, :, :] = CellType.WALL
    geo[1:nx - 1, :, :] = CellType.FLUID
    return CaseSpec(name="chan", shape=(nx, ny, nz), tau=tau,
                    units=_UNITS, mask=geo, boundaries=[],
                    force=(0.0, Fy, 0.0), **kw)


def test_couette_stress_constant():
    nx, ny, nz = 10, 8, 8
    tau, U = 0.8, 0.05
    geo = np.zeros((nx, ny, nz), np.int32)
    geo[0] = CellType.WALL
    geo[nx - 1] = CellType.MOVING
    geo[1:nx - 1] = CellType.FLUID
    spec = CaseSpec(name="couette", shape=(nx, ny, nz), tau=tau,
                    units=_UNITS, mask=geo, boundaries=[],
                    wall_velocity=(0.0, U, 0.0))
    cc = compile_case(spec)
    f, t = _run(cc, 4000)
    sigma, rho, u = stress_fields(cc, f, t)
    sxy = np.asarray(sigma)[3]
    m = np.asarray(cc.fluid)
    exact = (tau - 0.5) / 3.0 * U / (nx - 2)  # rho nu dU/dx, rho ~ 1
    np.testing.assert_allclose(sxy[m], exact, rtol=2e-3)
    # other components are small — not fp32-zero: f_neq's second moment
    # carries Burnett-order rho tau^2 (du/dx)^2 diagonal terms
    # (~ 2e-5 here, 3% of sigma_xy — scales as measured with (U/W)^2)
    for comp in (0, 1, 2, 4, 5):
        assert np.abs(np.asarray(sigma)[comp][m]).max() < 0.05 * exact
    # WSS at both walls equals the (constant) shear stress
    w = np.asarray(wss_field(cc, f, t))
    assert (w[1] > 0).all() and (w[nx - 2] > 0).all()
    assert (w[2:nx - 2] == 0).all()
    np.testing.assert_allclose(w[[1, nx - 2]], exact, rtol=2e-3)


def test_gravity_channel_stress_linear():
    """sigma_xy(x) = rho F (c - x): momentum balance, with the Guo
    second-moment correction active (force is on)."""
    spec = _channel_spec()
    cc = compile_case(spec)
    f, t = _run(cc, 6000)
    sigma, rho, u = stress_fields(cc, f, t)
    sxy = np.asarray(sigma)[3][:, 4, 4]
    W = spec.shape[0] - 2.0
    xi = np.arange(spec.shape[0]) - 0.5
    exact = 1e-5 * (W / 2.0 - xi)
    m = np.asarray(cc.fluid)[:, 4, 4]
    np.testing.assert_allclose(sxy[m], exact[m], rtol=0.02,
                               atol=1e-5 * 0.02)
    w = np.asarray(wss_field(cc, f, t))[:, 4, 4]
    np.testing.assert_allclose(w[[1, spec.shape[0] - 2]],
                               1e-5 * (W / 2.0 - 0.5), rtol=0.02)


def test_power_law_channel_stress_matches_newtonian():
    """The stress profile is set by momentum balance alone: the
    shear-thinning run (tau_eff spanning ~0.6..20 across the gap) must
    land on the SAME sigma_xy(x) = rho F (c - x) — the sharpest test of
    the per-cell -(1 - 1/(2 tau_eff)) prefactor."""
    spec = _channel_spec(
        rheology={"model": "power_law", "K": 0.01, "n": 0.7})
    cc = compile_case(spec)
    f, t = _run(cc, 6000)
    sigma, _, _ = stress_fields(cc, f, t)
    sxy = np.asarray(sigma)[3][:, 4, 4]
    W = spec.shape[0] - 2.0
    xi = np.arange(spec.shape[0]) - 0.5
    exact = 1e-5 * (W / 2.0 - xi)
    m = np.asarray(cc.fluid)[:, 4, 4]
    # drop the centerline cells: there gamma -> 0 hits the tau_eff clip
    # (te_hi = 20), where the closure's nu is no longer the fluid's
    inner = m & (np.abs(xi - W / 2.0) > 1.0)
    np.testing.assert_allclose(sxy[inner], exact[inner], rtol=0.04)


def test_wall_normals_flat_and_edge():
    geo = np.zeros((6, 6, 6), np.int32)
    geo[0] = CellType.WALL
    geo[:, 0] = CellType.WALL
    geo[1:, 1:] = CellType.FLUID
    n = wall_normals(geo)
    # flat-wall fluid cell: unit -x normal (toward the solid)
    np.testing.assert_allclose(n[:, 1, 3, 3], [-1.0, 0.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(n[:, 3, 1, 3], [0.0, -1.0, 0.0],
                               atol=1e-6)
    # edge cell sees both walls: diagonal unit normal
    np.testing.assert_allclose(n[:, 1, 1, 3],
                               [-np.sqrt(0.5), -np.sqrt(0.5), 0.0],
                               atol=1e-6)
    # interior fluid: no normal
    assert (n[:, 3, 3, 3] == 0).all()
    mag = np.sqrt((n * n).sum(axis=0))
    assert np.allclose(mag[mag > 0], 1.0, atol=1e-6)


@pytest.mark.parametrize("backend", ["sparse", "gspmd"])
def test_sim_wss_backend_equivalence(backend):
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.parallel.mesh import lattice_mesh

    spec = get_case("poiseuille", n=16)
    ref = Simulation(spec, backend="xla")
    other = (Simulation(spec, backend="xla", mesh=lattice_mesh())
             if backend == "gspmd" else Simulation(spec, backend=backend))
    for s in (ref, other):
        s.run(max_steps=20, time_save=20, verbose=False)
    w_ref = np.asarray(ref.wss())
    w = np.asarray(other.wss())
    assert w_ref.max() > 0
    np.testing.assert_allclose(w, w_ref, rtol=3e-5, atol=1e-9)


def test_vtk_includes_wss(tmp_path):
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.io.vtk import case_vtk

    sim = Simulation(get_case("lid_driven_cavity", n=16), backend="xla")
    sim.run(max_steps=20, time_save=20, verbose=False)
    path = case_vtk(sim, str(tmp_path), sim.t, include_wss=True)
    txt = open(path).read()
    assert "WSS" in txt


# ---------------------------------------------------------------------
# Pulsatile statistics: TAWSS + OSI (engine/stress.WSSAccumulator)


def test_osi_zero_on_steady_flow():
    """Unidirectional traction: OSI = 0 identically, TAWSS = the
    instantaneous WSS."""
    from lbm_jax.engine.stress import WSSAccumulator

    spec = _channel_spec()
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(4000):
        f, _, _ = step(f, jnp.int32(t))
    acc = WSSAccumulator(cc)
    for k in range(5):
        acc.sample(f, 4000 + 10 * k)
        for _ in range(10):
            f, _, _ = step(f, jnp.int32(0))
    osi = np.asarray(acc.osi())
    wall = np.asarray((acc.normals != 0).any(axis=0))
    assert osi[wall].max() < 1e-3
    w_now = np.asarray(wss_field(cc, f, 0, acc.normals))
    np.testing.assert_allclose(np.asarray(acc.tawss())[wall],
                               w_now[wall], rtol=1e-3)


def test_osi_half_on_reversing_flow():
    """A zero-mean oscillatory pipe (series-driven at both ends): the
    traction reverses each half-period, so OSI -> 1/2 at the wall
    while a steady-component control stays low."""
    from lbm_jax.engine.stress import WSSAccumulator
    from lbm_jax.geometry.shapes import pipe_mask

    nxz, ny = 16, 24
    tau, period, amp = 0.8, 400, 0.02
    mask = pipe_mask(nxz, ny, nxz)
    cx = cz = (nxz - 1) / 2.0
    R = (nxz - 1) / 2.0 - 0.5
    x = np.arange(nxz)[:, None]
    z = np.arange(nxz)[None, :]
    r2 = ((x - cx) ** 2 + (z - cz) ** 2) / R**2
    prof = np.clip(1.0 - r2, 0.0, None).astype(np.float32)
    nphase = 16
    stride = period // nphase
    series = np.zeros((nphase, 3, nxz, nxz), np.float32)
    for p in range(nphase):
        series[p, 1] = amp * prof * np.sin(
            2 * np.pi * (p + 0.5) * stride / period)
    bc_kw = dict(rho_mode="extrapolate", u_mode="series",
                 u_series=series, u_series_stride=stride)
    spec = CaseSpec(
        name="osc_pipe", shape=(nxz, ny, nxz), tau=tau,
        units=_UNITS, mask=mask,
        boundaries=[
            PlaneBC(mask_value=int(CellType.INLET), axis=1, coord=1,
                    normal=+1, **bc_kw),
            PlaneBC(mask_value=int(CellType.OUTLET), axis=1,
                    coord=ny - 2, normal=-1, **bc_kw),
        ])
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    t = 0
    for _ in range(2 * period):  # spin-up: 2 periods
        f, _, _ = step(f, jnp.int32(t))
        t += 1
    acc = WSSAccumulator(cc)
    for _ in range(nphase):  # one full period, phase-uniform samples
        for _ in range(stride):
            f, _, _ = step(f, jnp.int32(t))
            t += 1
        acc.sample(f, t)
    osi = np.asarray(acc.osi())
    tawss = np.asarray(acc.tawss())
    # score where the traction signal is meaningful (mid-pipe wall ring,
    # away from the driven ends)
    wall = np.asarray((acc.normals != 0).any(axis=0))
    ring = wall & (np.arange(ny)[None, :, None] == ny // 2)
    assert tawss[ring].max() > 0
    strong = ring & (tawss > 0.25 * tawss[ring].max())
    assert np.median(osi[strong]) > 0.4, (
        f"median OSI {np.median(osi[strong]):.3f}"
    )


def test_wss_sparse_route_matches_dense():
    """The O(live-cell) WSS route (Simulation._sparse_cc_f ->
    compacted stress) agrees with the dense pull of the same state on
    the coronary tree, where the BC fixups are active."""
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.engine.sparse import scatter_dense
    from lbm_jax.engine.stress import (
        compact_normals,
        wss_field,
        wss_sparse,
    )

    spec = get_case("coronary", shape=(48, 24, 40), radius=5)
    sim = Simulation(spec, backend="sparse")
    sim.run(max_steps=10, time_save=10, verbose=False)
    cc, f = sim._dense_cc_f()
    w_dense = np.asarray(wss_field(
        cc, f, sim.t, wall_normals(spec.mask, spec.wall_sdf)))
    sc, f_s = sim._sparse_cc_f()
    normals = compact_normals(
        sc, wall_normals(spec.mask, spec.wall_sdf))
    w_sparse = np.asarray(
        scatter_dense(sc, wss_sparse(sc, f_s, sim.t, normals)))
    assert w_dense.max() > 0
    np.testing.assert_allclose(w_sparse, w_dense, rtol=3e-5, atol=1e-9)


def test_stress_sparse_matches_dense_force_closure():
    """stress_fields_sparse carries the Guo force correction and the
    per-cell closure tau_eff exactly like the dense path (the power-law
    channel spans tau_eff ~0.6-20 across the gap)."""
    from lbm_jax.engine.sparse import compile_sparse, scatter_dense
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.engine.stress import stress_fields_sparse

    spec = _channel_spec(rheology={"model": "power_law", "K": 0.01,
                                   "n": 0.7})
    sim_d = Simulation(spec, backend="xla")
    sim_s = Simulation(spec, backend="sparse")
    for s in (sim_d, sim_s):
        s.run(max_steps=30, time_save=30, verbose=False)
    sig_d, rho_d, _ = sim_d.stress()
    sig_s, rho_s, _ = stress_fields_sparse(sim_s.sc, sim_s.f, sim_s.t)
    sig_s = np.asarray(scatter_dense(sim_s.sc, sig_s))
    fl = np.asarray(spec.mask) == CellType.FLUID
    assert np.abs(np.asarray(sig_d)[3][fl]).max() > 0
    np.testing.assert_allclose(sig_s[:, fl], np.asarray(sig_d)[:, fl],
                               rtol=3e-5, atol=1e-9)


def test_sparse_wss_accumulator_matches_dense():
    """SparseWSSAccumulator (the 512^3 TAWSS/OSI route) must agree with
    the dense accumulator sample-for-sample; the *_field accessors
    erase the layout difference."""
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.engine.stress import WSSAccumulator

    spec = get_case("poiseuille", n=16)
    sim = Simulation(spec, backend="sparse")
    acc_s = sim.wss_accumulator()
    from lbm_jax.engine.stress import SparseWSSAccumulator

    assert isinstance(acc_s, SparseWSSAccumulator)
    cc = compile_case(spec)
    acc_d = WSSAccumulator(cc)
    for k in range(3):
        sim.run(max_steps=8, time_save=8, verbose=False)
        acc_s.sample_sim(sim)
        acc_d.sample(jnp.asarray(sim.f_standard()), sim.t)
    wall = np.asarray((acc_d.normals != 0).any(axis=0))
    ts = np.asarray(acc_s.tawss_field())
    td = np.asarray(acc_d.tawss_field())
    assert td[wall].max() > 0
    np.testing.assert_allclose(ts, td, rtol=3e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(acc_s.osi_field())[wall],
                               np.asarray(acc_d.osi_field())[wall],
                               rtol=1e-3, atol=1e-5)
