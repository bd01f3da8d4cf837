"""Boussinesq thermal coupling tests (engine/thermal.py +
scalar.dirichlet_walls + step.make_step_force).

Anchors:
  * pure conduction between isothermal (anti-bounce-back) walls lands
    on the EXACT linear profile with half-way wall placement — fp32
    rounding only,
  * a uniform-temperature box under buoyancy reproduces the constant
    CaseSpec.force Guo path (the per-cell force-field code degenerates
    correctly to the measured constant-force machinery),
  * Rayleigh-Benard onset straddles the rigid-rigid critical number
    Ra_c = 1708: kinetic energy stays at the discrete-hydrostatic
    floor at Ra = 800 and grows orders of magnitude into a finite-
    amplitude roll at Ra = 3000,
  * the differentially heated square cavity reproduces de Vahl Davis'
    benchmark mean Nusselt numbers (Ra = 1e3: 1.118, measured 1.116 at
    26^2; Ra = 1e4: 2.243, measured 2.230 at 34^2) with a plane-
    independent steady flux profile,
  * an absorbing wall (c_w = 0) drains a closed box monotonically
    (the frozen-field ScalarTransport route of the same wall).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases.thermal import heated_cavity, rayleigh_benard
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.scalar import ScalarTransport
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.engine.thermal import BuoyantTransport
from lbm_jax.geometry.mask import CellType


def _closed_box(n: int, tau: float = 0.8,
                force=None) -> CaseSpec:
    mask = np.full((n, n, n), int(CellType.WALL), np.int32)
    mask[1:-1, 1:-1, 1:-1] = int(CellType.FLUID)
    return CaseSpec(name="box", shape=(n, n, n), tau=tau,
                    units=UnitSystem(CH=1e-4, C_U=1.0), mask=mask,
                    boundaries=[], force=force)


def test_conduction_linear_profile():
    """Zero buoyancy + isothermal top/bottom walls -> the steady state
    is the exact conduction profile, wall values pinned HALF-WAY
    between the wall and fluid layers (the anti-bounce-back placement
    proof): max error at cell centers is fp32 rounding."""
    spec, kw, info = rayleigh_benard(nx=8, ny=1, nz=18, ra=0.0,
                                     tau=0.8, perturb=0.0)
    bt = BuoyantTransport(spec, **kw)
    bt.run(3000)
    c = np.asarray(bt.concentration())[4, 0, 1:-1]
    z = np.arange(1, 17, dtype=np.float64)
    lin = 0.5 - (z - 0.5) / info["H"]
    assert np.abs(c - lin).max() < 1e-6
    # and the flow never moved (hydrostatics needs buoyancy to break)
    _, u = bt.macro()
    assert float(jnp.abs(u).max()) == 0.0


def test_uniform_c_buoyancy_matches_constant_force():
    """c0 uniform = 2, c_ref = 0, buoyancy b -> the flow must follow
    the constant-force Guo path with F = 2 b while c stays uniform (a
    closed adiabatic box keeps it uniform up to O(div u) rounding).
    Validates the per-cell force-field branches of half_force_shift /
    guo_source against the measured constant machinery."""
    from lbm_jax.engine.compile import compile_case
    from lbm_jax.engine.step import initial_f, make_step

    b = (2e-6, 0.0, 5e-6)
    n_steps = 12
    spec = _closed_box(10)
    bt = BuoyantTransport(spec, tau_g=0.9, buoyancy=b, c_ref=0.0,
                          c0=np.full((10, 10, 10), 2.0, np.float32))
    bt.run(n_steps)

    spec_f = _closed_box(10, force=tuple(2.0 * v for v in b))
    cc = compile_case(spec_f)
    step = make_step(cc)
    f = initial_f(cc)
    for t in range(n_steps):
        f, _, _ = step(f, jnp.int32(t))
    np.testing.assert_allclose(np.asarray(bt.f), np.asarray(f),
                               rtol=0.0, atol=1e-6)
    # c stayed uniform through the coupled advance (up to the scheme's
    # O(div u) drift, here u ~ 4e-5 after 12 forced steps)
    c = np.asarray(bt.concentration())[1:-1, 1:-1, 1:-1]
    np.testing.assert_allclose(c, 2.0, atol=1e-3)


def test_rayleigh_benard_onset():
    """Perturbation kinetic energy decays (to the tiny discrete-
    hydrostatic floor) at Ra = 800 < Ra_c = 1708 and grows orders of
    magnitude into a finite-amplitude convection roll at Ra = 3000."""
    energies = {}
    for ra in (800.0, 3000.0):
        spec, kw, info = rayleigh_benard(nx=32, ny=1, nz=18, ra=ra,
                                         tau=0.8, perturb=1e-3)
        bt = BuoyantTransport(spec, **kw)
        energies[ra] = bt.run(4000, record_energy=True)
    sub, sup = energies[800.0], energies[3000.0]
    assert sub[3999] <= sub[500] * 1.05          # no growth below onset
    assert sup[3999] > 100.0 * sup[500]          # strong growth above
    assert sup[3999] > 1e5 * sub[3999]           # and a real roll
    assert np.isfinite(sup).all()


def test_heated_cavity_nusselt_ra1e3():
    """de Vahl Davis (1983) square cavity, Ra = 1e3, Pr = 0.71:
    benchmark mean Nusselt 1.118. Measured 1.116 at 26^2 with the
    flux profile plane-independent to <1% (the steady-state
    self-check)."""
    spec, kw, info = heated_cavity(n=26, ra=1e3, tau=0.66)
    bt = BuoyantTransport(spec, **kw)
    for _ in range(6):
        e = bt.run(5000, record_energy=True)
    # converged: kinetic energy flat over the last chunk
    assert abs(e[-1] - e[0]) < 1e-3 * abs(e[0])
    _, nu = bt.nusselt_profile(hot_axis=0, kappa=info["kappa"],
                               dT=1.0, H=info["H"])
    assert nu.max() - nu.min() < 0.01 * nu.mean()
    assert abs(nu.mean() - 1.118) < 0.03
    assert nu.mean() > 1.05           # convection, not conduction


@pytest.mark.slow
def test_heated_cavity_nusselt_ra1e4():
    """Ra = 1e4 (stronger convection): benchmark Nu = 2.243, measured
    2.230 at 34^2 (0.6%)."""
    spec, kw, info = heated_cavity(n=34, ra=1e4, tau=0.56)
    bt = BuoyantTransport(spec, **kw)
    for _ in range(8):
        e = bt.run(15000, record_energy=True)
    assert abs(e[-1] - e[0]) < 1e-3 * abs(e[0])
    _, nu = bt.nusselt_profile(hot_axis=0, kappa=info["kappa"],
                               dT=1.0, H=info["H"])
    assert nu.max() - nu.min() < 0.02 * nu.mean()
    assert abs(nu.mean() - 2.243) < 0.07


def test_buoyancy_composes_with_les_closure():
    """The per-cell force field rides the closure's variable-rate Guo
    prefactor (post_collision's tau_local branch): a Smagorinsky-LES
    heated cavity at Ra = 1e4 runs stable and still transports heat
    (Nu > 1.5) — at these laminar scales the eddy viscosity is a small
    perturbation, not a new physics anchor; this guards the
    closure x field-force composition path."""
    spec, kw, info = heated_cavity(n=20, ra=1e4, tau=0.56)
    spec.smagorinsky_cs = 0.1
    bt = BuoyantTransport(spec, **kw)
    for _ in range(4):
        e = bt.run(10000, record_energy=True)
    assert np.isfinite(e).all()
    _, nu = bt.nusselt_profile(hot_axis=0, kappa=info["kappa"],
                               dT=1.0, H=info["H"])
    assert np.isfinite(nu).all() and nu.mean() > 1.5


def test_gspmd_sharded_thermal_matches_single_device():
    """mesh= on BuoyantTransport: the 8-device CPU-mesh Rayleigh-Benard
    run (super-critical, so the fields are genuinely evolving) matches
    single-device on both states and the energy series — the buoyancy
    force field is elementwise in the sharded c, the rolls become
    one-deep halo CollectivePermutes, the energy sum a psum."""
    import jax

    from lbm_jax.parallel.mesh import lattice_mesh

    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    n_steps = 48   # info crosses several 4-wide shards of the nx=32 slab
    spec, kw, info = rayleigh_benard(nx=32, ny=1, nz=18, ra=3000.0,
                                     tau=0.8, perturb=1e-3)
    bt = BuoyantTransport(spec, **kw)
    ref = bt.run(n_steps, record_energy=True)
    bt_sh = BuoyantTransport(spec, mesh=lattice_mesh(), shard_axis=0,
                             **kw)
    got = bt_sh.run(n_steps, record_energy=True)
    np.testing.assert_allclose(got, ref, rtol=3e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(bt_sh.g), np.asarray(bt.g),
                               rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(bt_sh.f), np.asarray(bt.f),
                               rtol=3e-6, atol=1e-7)


def test_checkpoint_roundtrip(tmp_path):
    """save -> run 20 -> vs restore -> run 20: the resumed trajectory
    is bit-identical to the uninterrupted one on both states."""
    spec, kw, info = rayleigh_benard(nx=16, ny=1, nz=10, ra=3000.0,
                                     tau=0.8)
    bt = BuoyantTransport(spec, **kw)
    bt.run(30)
    p = str(tmp_path / "thermal.npz")
    bt.save(p)
    bt.run(20)
    f_ref, g_ref = np.asarray(bt.f), np.asarray(bt.g)

    bt2 = BuoyantTransport(spec, **kw)
    bt2.restore(p)
    assert bt2.t == 30
    bt2.run(20)
    np.testing.assert_array_equal(np.asarray(bt2.f), f_ref)
    np.testing.assert_array_equal(np.asarray(bt2.g), g_ref)

    spec_o, kw_o, _ = rayleigh_benard(nx=16, ny=1, nz=10)
    spec_o.name = "other"
    with pytest.raises(ValueError):
        BuoyantTransport(spec_o, **kw_o).restore(p)


def test_absorbing_wall_drains_box():
    """The same Dirichlet wall on the frozen-field route: c_w = 0 on
    every wall of a closed box turns the conserving bounce-back into a
    perfectly absorbing boundary — total content decays monotonically
    toward zero (a diffusion-limited uptake problem)."""
    n = 12
    spec = _closed_box(n)
    wall_c = np.full((n, n, n), np.nan, np.float32)
    wall = np.asarray(spec.mask) == int(CellType.WALL)
    wall_c[wall] = 0.0
    u = np.zeros((3, n, n, n), np.float32)
    st = ScalarTransport(spec, u, tau_g=0.9,
                         c0=np.ones((n, n, n), np.float32),
                         wall_c=wall_c, div_fix=False)
    tot = [st.total()]
    for _ in range(6):
        st.run(50)
        tot.append(st.total())
    tot = np.asarray(tot)
    assert np.all(np.diff(tot) < 0.0)
    assert tot[-1] < 0.05 * tot[0]
    # without the Dirichlet wall the same box CONSERVES (the control)
    st2 = ScalarTransport(spec, u, tau_g=0.9,
                          c0=np.ones((n, n, n), np.float32),
                          div_fix=False)
    t0 = st2.total()
    st2.run(300)
    assert abs(st2.total() - t0) < 1e-3 * abs(t0)


def test_rayleigh_benard_3d_conduction_profile_exact():
    """The walled 3D box (isothermal plates, rigid adiabatic side
    walls) with no buoyancy: the steady field is the exact linear
    conduction profile between the half-way plate positions, in every
    column, and the flow never moves."""
    from lbm_jax.cases.thermal import rayleigh_benard_3d

    spec, kw, info = rayleigh_benard_3d(nx=6, ny=6, nz=14, ra=0.0,
                                        perturb=0.0)
    bt = BuoyantTransport(spec, **kw)
    bt.run(3000)
    c = np.asarray(bt.concentration())[1:-1, 1:-1, 1:-1]
    z = np.arange(1, 13, dtype=np.float64)
    lin = 0.5 - (z - 0.5) / info["H"]
    assert np.abs(c - lin[None, None, :]).max() < 1e-5
    _, u = bt.macro()
    assert float(jnp.abs(u).max()) == 0.0


def test_heated_cavity_3d_conduction_limit():
    """The differentially heated cube at Ra -> 0: conduction only, so
    the hot-wall Nusselt number is 1 on every plane."""
    from lbm_jax.cases.thermal import heated_cavity_3d

    spec, kw, info = heated_cavity_3d(n=10, ra=1e-3)
    bt = BuoyantTransport(spec, **kw)
    bt.run(2000)
    _, nu = bt.nusselt_profile(0, info["kappa"], info["dT"], info["H"])
    np.testing.assert_allclose(nu, 1.0, atol=2e-3)


def test_rayleigh_benard_3d_below_onset_stays_still():
    """Ra = 800 < 1708 in the walled box: no convective growth — the
    kinetic energy stays at its discrete-hydrostatic floor (the
    criterion of test_rayleigh_benard_onset)."""
    from lbm_jax.cases.thermal import rayleigh_benard_3d

    spec, kw, _ = rayleigh_benard_3d(nx=12, ny=12, nz=10, ra=800.0)
    bt = BuoyantTransport(spec, **kw)
    e = bt.run(1500, record_energy=True)
    assert np.isfinite(e).all()
    assert e[-1] <= e[200] * 1.05
