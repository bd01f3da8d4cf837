"""Passive scalar transport tests (engine/scalar.py, D3Q7 ADE-LBM).

Anchors:
  * pure diffusion: a Gaussian blob's per-axis variance grows as
    exactly 2 D t with D = c_s^2 (tau_g - 1/2) — the scheme's
    diffusivity is the nominal one,
  * closed box: bounce-back walls conserve total scalar to fp32,
  * uniform advection: the blob's center of mass rides the frozen
    velocity field at exactly u per step,
  * pipe wash-in: prescribed inlet concentration fills the pipe and the
    outlet curve saturates at the inlet value,
  * bolus washout: a time-gated inlet pulse produces the clinical
    rise-then-decay outlet curve,
  * mean-age mode (source=1, inlet c=0): age increases monotonically
    downstream and scales with the transit time.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.runner import Simulation
from lbm_jax.engine.scalar import ScalarTransport, tau_g_of
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType


def _closed_box(n: int) -> CaseSpec:
    mask = np.full((n, n, n), int(CellType.WALL), np.int32)
    mask[1:-1, 1:-1, 1:-1] = int(CellType.FLUID)
    return CaseSpec(name="box", shape=(n, n, n), tau=0.6,
                    units=UnitSystem(CH=1e-4, C_U=1.0), mask=mask,
                    boundaries=[])


def _gaussian(n: int, sigma: float) -> np.ndarray:
    x = np.arange(n) - (n - 1) / 2.0
    r2 = (x[:, None, None] ** 2 + x[None, :, None] ** 2
          + x[None, None, :] ** 2)
    return np.exp(-r2 / (2 * sigma**2)).astype(np.float32)


def _moments(c: np.ndarray):
    tot = c.sum()
    out = []
    for a in range(3):
        x = np.arange(c.shape[a], dtype=np.float64)
        sh = [1, 1, 1]
        sh[a] = -1
        x = x.reshape(sh)
        mean = float((c * x).sum() / tot)
        out.append((mean, float((c * (x - mean) ** 2).sum() / tot)))
    return out


def test_diffusion_variance_and_conservation():
    """Quiescent closed box: var(t) = var(0) + 2 D t on every axis, and
    bounce-back walls conserve the total scalar exactly."""
    n, D, steps = 48, 0.05, 200
    spec = _closed_box(n)
    u = np.zeros((3, n, n, n), np.float32)
    st = ScalarTransport(spec, u, D=D, c0=_gaussian(n, 3.0))
    assert st.tau_g == pytest.approx(tau_g_of(D))
    tot0 = st.total()
    m0 = _moments(np.asarray(st.concentration()))
    st.run(steps)
    c = np.asarray(st.concentration())
    assert np.isfinite(c).all() and c.min() > -1e-6
    np.testing.assert_allclose(st.total(), tot0, rtol=2e-4)
    for a, (mean0, var0) in enumerate(_moments(c)):
        # mean stays centered; variance grows at exactly 2 D per step
        assert abs(mean0 - m0[a][0]) < 1e-3
        np.testing.assert_allclose(var0 - m0[a][1], 2 * D * steps,
                                   rtol=2e-2)


def test_uniform_advection_center_of_mass():
    """Frozen uniform u along the duct's periodic axis: the blob's
    center of mass moves u per step (the ADE equilibrium's first moment
    is the exact advective flux)."""
    n, nz, uz, steps = 40, 64, 0.08, 150
    spec = get_case("gravity_channel", n=n, nz=nz)
    fluid = np.asarray(spec.mask) == CellType.FLUID
    u = np.zeros((3, n, n, nz), np.float32)
    u[2] = np.where(fluid, uz, 0.0)
    c0 = np.zeros((n, n, nz), np.float32)
    blob = _gaussian(15, 2.5)
    c0[n // 2 - 7:n // 2 + 8, n // 2 - 7:n // 2 + 8, 9:24] = blob
    c0[~fluid] = 0.0
    st = ScalarTransport(spec, u, D=0.01, c0=c0)
    z0 = _moments(np.asarray(st.concentration()))[2][0]
    tot0 = st.total()
    st.run(steps)
    c = np.asarray(st.concentration())
    z1 = _moments(c)[2][0]
    np.testing.assert_allclose(z1 - z0, uz * steps, rtol=1e-2)
    np.testing.assert_allclose(st.total(), tot0, rtol=2e-4)


def _frozen_pipe(n=16, flow_steps=300):
    spec = get_case("poiseuille", n=n)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=flow_steps, time_save=flow_steps, verbose=False)
    _, u = sim.macro()
    return spec, jnp.asarray(u)


def test_pipe_washin_saturates():
    """Constant inlet concentration on the converged pipe flow: the
    outlet curve rises monotonically (after the transit delay) and
    saturates at the inlet value; concentrations stay in [0, ~1]."""
    spec, u = _frozen_pipe()
    st = ScalarTransport(spec, u, D=0.02, inlet_c={0: 1.0})
    series = st.run(1200, record=[1])
    assert series.shape == (1200, 1)
    out = series[:, 0]
    assert out[0] < 1e-4 and out[-1] > 0.95
    # monotone rise up to the scheme's dispersive precursor wiggles
    # (measured ~5e-4 around zero just before the front arrives)
    assert np.all(np.diff(out) > -1e-3)
    c = np.asarray(st.concentration())
    assert c.min() > -1e-3 and c.max() < 1.05
    fluid = np.asarray(spec.mask) == CellType.FLUID
    assert c[fluid].mean() > 0.9


def test_bolus_washout_curve():
    """Time-gated inlet pulse (virtual contrast injection): the outlet
    curve rises after the transit delay, peaks, then washes out — the
    clinical bolus-tracking shape."""
    spec, u = _frozen_pipe()
    bolus = lambda t: jnp.where(t < 200, 1.0, 0.0)  # noqa: E731
    st = ScalarTransport(spec, u, D=0.02, inlet_c={0: bolus})
    series = st.run(1400, record=[1])[:, 0]
    peak = series.max()
    t_peak = int(series.argmax())
    assert peak > 0.5, "bolus must reach the outlet"
    assert 100 < t_peak < 800
    assert series[-1] < 0.2 * peak, "bolus must wash out"
    assert st.total() < peak * np.count_nonzero(
        np.asarray(spec.mask) == CellType.FLUID)


def test_mean_age_grows_downstream():
    """source=1 + zero inlet age: the steady concentration IS the mean
    age, which must increase monotonically downstream and land near the
    advective transit time scale."""
    spec, u = _frozen_pipe()
    st = ScalarTransport(spec, u, D=0.02, inlet_c={0: 0.0}, source=1.0)
    st.run(2000)
    c = np.asarray(st.concentration())
    n = c.shape[1]
    axis_age = c[c.shape[0] // 2, :, c.shape[2] // 2]  # centerline vs y
    inner = axis_age[3:n - 3]
    assert np.all(inner > 0)
    assert np.all(np.diff(inner) > 0), "age must grow downstream"
    # scale: centerline transit y/u_max, within a loose factor (diffusion
    # and the parabolic profile mix ages across the section)
    u_max = float(np.asarray(u)[1].max())
    transit = (n - 6) / u_max
    assert 0.5 * transit < inner[-1] < 3.0 * transit


def test_coupled_matches_frozen_on_converged_flow():
    """CoupledTransport (scalar advecting in the live per-step macro)
    degenerates to the frozen-field ScalarTransport when the flow is
    converged — same bolus curve, same field."""
    spec = get_case("poiseuille", n=16)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=2000, time_save=500, verbose=False)
    _, u = sim.macro()
    from lbm_jax.engine.scalar import CoupledTransport

    st_f = ScalarTransport(spec, u, D=0.02, inlet_c={0: 1.0})
    st_c = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0}, f0=sim.f)
    s_f = st_f.run(400, record=[1])[:, 0]
    s_c = st_c.run(400, record=[1])[:, 0]
    np.testing.assert_allclose(s_c, s_f, atol=2e-3)
    np.testing.assert_allclose(np.asarray(st_c.concentration()),
                               np.asarray(st_f.concentration()),
                               atol=5e-3)


def test_coupled_pulsatile_windkessel_composition():
    """The full unsteady clinical stack in ONE scan: series inlet +
    RCR outlet + live transport. The windkessel state threads the
    coupled carry and the bolus responds to the pulsatile flow."""
    from lbm_jax.engine.scalar import CoupledTransport

    wk = (5e-4, 24000.0, 2.5e-3)
    spec = get_case("curved_vessel", n=32, nphase=4, period_steps=8,
                    windkessel=wk)
    bolus = lambda t: jnp.where(t < 400, 1.0, 0.0)  # noqa: E731
    ct = CoupledTransport(spec, D=0.02, inlet_c={0: bolus})
    series = ct.run(1500, record=[1])[:, 0]
    assert np.isfinite(series).all()
    assert series.max() > 0.01, "bolus must reach the outlet"
    assert float(np.asarray(ct.wk)[0]) > 0, "RCR must charge"
    assert np.isfinite(np.asarray(ct.concentration())).all()
    c = np.asarray(ct.concentration())
    assert c.min() > -1e-2 and c.max() < 1.1


def test_inlet_c_validation_and_units():
    spec, u = _frozen_pipe(flow_steps=20)
    with pytest.raises(AssertionError, match="absent"):
        ScalarTransport(spec, u, D=0.02, inlet_c={7: 1.0})
    with pytest.raises(AssertionError):
        ScalarTransport(spec, u, D=0.02, tau_g=0.7)
    us = UnitSystem(CH=2e-4, C_U=0.5)
    D_phys = 3e-9  # contrast-agent-scale diffusivity, m^2/s
    assert us.to_lattice_diffusivity(D_phys) * us.CH * us.C_U == (
        pytest.approx(D_phys))


def test_scan_embeds_no_big_constants():
    """The big per-cell statics (phi/nbr/comp/fluid, and the coupled
    route's flow case) must thread through run()'s jit as ARGUMENTS:
    closed-over device arrays lower to HLO literals, and at the
    flagship coronary box the phi constant alone would be 882 MB of
    program. Guard: the traced scan's jaxpr consts stay tiny relative
    to the box."""
    import jax

    from lbm_jax.engine.scalar import CoupledTransport

    def const_bytes(fn, *args):
        jaxpr = jax.make_jaxpr(fn)(*args)
        return sum(np.asarray(c).nbytes for c in jaxpr.consts
                   if hasattr(c, "nbytes") or isinstance(c, np.ndarray))

    spec, u = _frozen_pipe(flow_steps=20)
    box = int(np.prod(spec.shape))

    st = ScalarTransport(spec, u, D=0.02, inlet_c={0: 1.0})
    st.run(2)   # builds + caches the scan fn
    (key, scan_fn), = st._scan_cache.items()
    cb = const_bytes(scan_fn, st.g, jnp.int32(0), st.fields)
    # the 7-channel state alone is 28 bytes/cell; anything O(box) that
    # leaks back into the consts trips this long before 413 territory
    assert cb < 4 * box, f"scan consts {cb} B leak O(box) data"

    ct = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0})
    ct.run(2)
    (key, scan_fn), = ct._scan_cache.items()
    cb = const_bytes(scan_fn, ct.f, ct.wk, ct.g, jnp.int32(0),
                     ct.fields)
    # the flow case's arrays (wall masks, BC planes) are arguments too
    assert cb < 4 * box, f"coupled scan consts {cb} B leak"


@pytest.mark.multichip
def test_gspmd_sharded_scalar_matches_single_device():
    """GSPMD decomposition of the transport (mesh= on both drivers):
    the 8-device CPU mesh run must match single-device field-for-field
    AND on the recorded plane series — the rolls become one-deep halo
    CollectivePermutes, the record sums psums, all inserted by the
    partitioner (the flow runner's backend='xla' mesh= mechanism)."""
    import jax

    from lbm_jax.engine.scalar import CoupledTransport
    from lbm_jax.parallel.mesh import lattice_mesh

    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    spec, u = _frozen_pipe()
    n_steps = 48   # >: info crosses several 2-wide shards of the n=16 pipe
    kw = dict(D=0.02, inlet_c={0: 1.0}, source=0.05)

    st = ScalarTransport(spec, u, **kw)
    ref = st.run(n_steps, record=[0, 1])
    mesh = lattice_mesh()
    st_sh = ScalarTransport(spec, u, mesh=mesh, **kw)
    got = st_sh.run(n_steps, record=[0, 1])
    np.testing.assert_allclose(got, ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(st_sh.g), np.asarray(st.g),
                               rtol=3e-6, atol=1e-7)

    # time-resolved route: flow + scalar advance together under the mesh
    ct = CoupledTransport(spec, **kw)
    ref = ct.run(n_steps, record=[1])
    ct_sh = CoupledTransport(spec, mesh=mesh, **kw)
    got = ct_sh.run(n_steps, record=[1])
    np.testing.assert_allclose(got, ref, rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ct_sh.g), np.asarray(ct.g),
                               rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ct_sh.f), np.asarray(ct.f),
                               rtol=3e-6, atol=1e-7)


# ---------------------------------------------------------------------
# The dense twins at the options the clinical washout runs use (bolus
# gate, source term, Dirichlet walls, the coupled pulsatile windkessel
# tree), each against an exact anchor of the linear scheme or of the
# flow runner.


def test_bolus_is_difference_of_step_responses():
    """With a frozen flow the ADE scheme is linear and time-invariant,
    so a gate of length G is exactly the step response minus the step
    response delayed by G (div_fix off, as the coupled clinical route
    runs it)."""
    spec, u = _frozen_pipe(flow_steps=200)
    gate, n = 60, 300
    step = ScalarTransport(spec, u, D=0.02, inlet_c={0: 1.0},
                           div_fix=False).run(n, record=[1])[:, 0]
    bolus = lambda t: jnp.where(t < gate, 1.0, 0.0)  # noqa: E731
    pulse = ScalarTransport(spec, u, D=0.02, inlet_c={0: bolus},
                            div_fix=False).run(n, record=[1])[:, 0]
    expect = step.copy()
    expect[gate:] -= step[:n - gate]
    assert pulse.max() > 0.05
    np.testing.assert_allclose(pulse, expect, atol=2e-5)


def _frozen_tree(flow_steps=300):
    spec = get_case("coronary", shape=(48, 24, 40), radius=5)
    sim = Simulation(spec)
    sim.run(max_steps=flow_steps, time_save=flow_steps, verbose=False)
    return spec, jnp.asarray(sim.macro()[1])


def test_source_response_is_linear_on_tree():
    """Mean-age mode on the branched tree (source, zero inlet, three
    z-plane sub-outlets): doubling the source doubles the field."""
    spec, u = _frozen_tree()
    c = []
    for s in (1.0, 2.0):
        st = ScalarTransport(spec, u, D=0.02, inlet_c={0: 0.0}, source=s)
        st.run(200)
        c.append(np.asarray(st.concentration()))
    fluid = np.asarray(spec.mask) == CellType.FLUID
    assert c[0][fluid].max() > 1.0
    np.testing.assert_allclose(c[1], 2.0 * c[0], rtol=1e-5, atol=1e-5)


def test_coronary_bolus_reaches_every_outlet():
    """The washout composition on the tree: a gated inlet bolus arrives
    at the main outlet and the three sub-outlets, then washes out."""
    spec, u = _frozen_tree()
    bolus = lambda t: jnp.where(t < 300, 1.0, 0.0)  # noqa: E731
    st = ScalarTransport(spec, u, D=0.05, inlet_c={0: bolus})
    series = st.run(2500, record=[1, 2, 3, 4])
    assert np.isfinite(series).all()
    peaks = series.max(axis=0)
    assert (peaks > 1e-3).all(), peaks
    assert (series[-1] < 0.5 * peaks).all(), (series[-1], peaks)


def test_dirichlet_walls_linear_conduction_profile():
    """wall_c pins the scalar by anti-bounce-back HALF-WAY between the
    wall and the first fluid layer: with no flow, hot and cold x-walls
    and adiabatic others, the steady field is the exact linear profile
    through those half-way points."""
    n = 12
    spec = _closed_box(n)
    wall_c = np.full((n, n, n), np.nan, np.float32)
    wall_c[0] = 1.0
    wall_c[-1] = 0.0
    u = np.zeros((3, n, n, n), np.float32)
    st = ScalarTransport(spec, u, D=0.1, wall_c=wall_c, div_fix=False)
    st.run(4000)
    c = np.asarray(st.concentration())[1:-1, n // 2, n // 2]
    x = np.arange(1, n - 1, dtype=np.float64)
    lin = 1.0 - (x - 0.5) / (n - 2)
    assert np.abs(c - lin).max() < 1e-4


def test_coupled_clinical_flow_matches_runner():
    """The coupled scan's flow half IS the runner's step: on the
    clinical composition (pulsatile series inlet, four RCR outlets,
    Carreau blood) its f and windkessel state equal Simulation's."""
    from lbm_jax.engine.scalar import CoupledTransport

    rheo = {"model": "carreau", "nu0": 0.3, "nu_inf": 0.02,
            "lam": 3000.0, "n": 0.5}
    spec = get_case("coronary", shape=(48, 24, 40), radius=5,
                    pulsatile=(4, 8), rheology=rheo,
                    windkessel=[(1e-4, 5e3, 2e-3)] * 4)
    ct = CoupledTransport(spec, D=0.02, inlet_c={0: 1.0}, div_fix=False)
    series = ct.run(40, record=[0, 1])
    sim = Simulation(spec)
    sim.run(max_steps=40, time_save=40, verbose=False)
    assert np.isfinite(series).all()
    np.testing.assert_allclose(np.asarray(ct.f), np.asarray(sim.f),
                               rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ct.wk), np.asarray(sim.wk),
                               rtol=3e-6, atol=1e-9)


def test_coupled_total_conserved_in_closed_box():
    """Bounce-back walls on every side (the moving-wall lid included):
    the coupled scalar in the conservative form (div_fix off) has
    nowhere to go, so its total is conserved while the lid drives a
    real flow through it."""
    from lbm_jax.engine.scalar import CoupledTransport

    spec = get_case("lid_driven_cavity", n=16, lid="bounceback")
    assert not spec.boundaries
    c0 = _gaussian(16, 2.5)
    c0[np.asarray(spec.mask) != CellType.FLUID] = 0.0
    ct = CoupledTransport(spec, D=0.02, c0=c0, div_fix=False)
    before = ct.total()
    ct.run(300)
    assert abs(ct.total() - before) < 1e-4 * before
    assert np.isfinite(np.asarray(ct.concentration())).all()
