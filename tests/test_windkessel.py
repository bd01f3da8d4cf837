"""Windkessel (RCR) outlet coupling tests (spec.PlaneBC.windkessel,
engine/step.windkessel_update).

Beyond-reference: the reference's outlets pin rho = 1
(/root/reference/bifurcation_cfd/bifurcation.cu:877-948), while clinical
hemodynamics terminates truncated vessels on lumped 3-element windkessel
models — P_in = Q Rp + P_c, C dP_c/dt = Q - P_c/Rd — so the outlet
pressure tracks the computed flow. Anchors:

  * the discrete update against the analytic RC exponential
    P_c(t) = Q Rd (1 - e^{-t/(Rd C)}) for constant Q,
  * steady state: with a velocity inlet the converged flux Q is fixed
    by the prescribed inlet parabola, so P_c -> Q Rd with NO free
    parameters,
  * degeneracy: C -> inf, Rp = 0 reduces to the plain pressure outlet,
  * unit conversions R_lat Q_lat = P_lat from SI,
  * dense/sparse equivalence, GSPMD-sharded equivalence through the
    Simulation runner, checkpoint round-trip of the carried state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case, wk_init
from lbm_jax.engine.runner import Simulation
from lbm_jax.engine.step import windkessel_update
from lbm_jax.geometry.mask import CellType

_WK = (5e-4, 24000.0, 2.5e-3)  # Rp, C, Rd (lattice); Rd C = 60 steps


def test_wk_update_matches_analytic_exponential():
    """Constant-Q charging of the RC pair: backward Euler tracks
    P_c(t) = Q Rd (1 - e^{-t/(Rd C)}) to O(dt/(Rd C)) and lands exactly
    on the Q Rd steady state; P_in adds the proximal drop Q Rp."""
    rp, cap, rd = 0.1, 400.0, 2.0  # Rd C = 800 steps
    q = 0.03
    p = jnp.float32(0.0)
    ps = []
    for _ in range(1600):
        p, p_in = windkessel_update(p, jnp.float32(q), (rp, cap, rd))
        ps.append(float(p))
    t = np.arange(1, 1601)
    exact = q * rd * (1.0 - np.exp(-t / (rd * cap)))
    np.testing.assert_allclose(ps, exact, rtol=5e-3, atol=1e-7)
    assert abs(float(p_in) - float(p) - q * rp) < 1e-8  # fp32 update


def test_wk_unit_conversions():
    """R_lat Q_lat == P_lat and C_lat == V_lat / P_lat for consistent
    SI values (UnitSystem.to_lattice_resistance/compliance)."""
    u = UnitSystem(CH=1e-4, C_U=0.2, C_rho=1060.0)
    R_phys, Q_phys = 1.2e9, 3e-6            # Pa s/m^3, m^3/s
    P_phys = R_phys * Q_phys                # Pa
    Q_lat = Q_phys * u.C_T / u.CH ** 3      # cells^3 / step
    P_lat = P_phys / u.C_pre
    np.testing.assert_allclose(
        u.to_lattice_resistance(R_phys) * Q_lat, P_lat, rtol=1e-12)
    C_phys = 2e-10                          # m^3/Pa
    V_lat = (C_phys * P_phys) / u.CH ** 3
    np.testing.assert_allclose(
        u.to_lattice_compliance(C_phys) * P_lat, V_lat, rtol=1e-12)


def _inlet_flux(spec) -> float:
    """The prescribed steady inlet flux (lattice units): sum of the
    inlet parabola over the inlet footprint."""
    inlet = spec.boundaries[0]
    foot = np.take(np.asarray(spec.mask), inlet.coord,
                   axis=inlet.axis) == inlet.mask_value
    return float(np.sum(np.asarray(inlet.u_field)[inlet.axis][foot]))


@pytest.mark.slow
def test_wk_steady_state_pressure():
    """With a velocity inlet the converged flux is pinned by the
    prescribed parabola, so the windkessel must settle at exactly
    P_c = Q Rd — a no-free-parameter anchor of the coupled system."""
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=1500, time_save=250, verbose=False)
    q_in = _inlet_flux(spec)
    p_c = float(np.asarray(sim.wk)[0])
    assert q_in > 0
    np.testing.assert_allclose(p_c, q_in * _WK[2], rtol=0.05)
    # the outlet-adjacent fluid plane's density carries the full RCR
    # pressure 1 + 3 Q (Rp + Rd) (plus the O(Ma^2) NEE offset)
    rho, _ = sim.macro()
    outlet = spec.boundaries[1]
    c = outlet.coord + outlet.normal
    foot = np.take(np.asarray(spec.mask), outlet.coord,
                   axis=outlet.axis) == outlet.mask_value
    rho_pl = np.take(np.asarray(rho), c, axis=outlet.axis)[foot]
    np.testing.assert_allclose(
        rho_pl.mean(), 1.0 + 3.0 * q_in * (_WK[0] + _WK[2]), rtol=0.02)


def test_wk_degenerates_to_fixed_pressure_outlet():
    """C -> inf, Rp = 0, P0 = 0: the RCR outlet IS the plain pressure
    outlet (P_c drift ~ Q t / C ~ 1e-9 over the horizon)."""
    spec_wk = get_case("poiseuille", n=16, windkessel=(0.0, 1e12, 1.0))
    spec_po = get_case("poiseuille", n=16, windkessel=(0.0, 1e12, 1.0))
    spec_po.boundaries[1] = dataclasses.replace(
        spec_po.boundaries[1], windkessel=None)
    sim_wk = Simulation(spec_wk, backend="xla")
    sim_po = Simulation(spec_po, backend="xla")
    for s in (sim_wk, sim_po):
        s.run(max_steps=300, time_save=100, verbose=False)
    np.testing.assert_allclose(
        np.asarray(sim_wk.f_standard()), np.asarray(sim_po.f_standard()),
        rtol=1e-4, atol=1e-8)
    assert abs(float(np.asarray(sim_wk.wk)[0])) < 1e-6


def test_wk_dense_sparse_equivalence():
    """The sparse backend's windkessel (footprint-sampled flux weights,
    gathered consumer plane) matches the dense fixup state-for-state."""
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    sim_d = Simulation(spec, backend="xla")
    sim_s = Simulation(spec, backend="sparse")
    for s in (sim_d, sim_s):
        s.run(max_steps=60, time_save=20, verbose=False)
    np.testing.assert_allclose(
        np.asarray(sim_s.wk), np.asarray(sim_d.wk), rtol=3e-5, atol=1e-9)
    live = np.asarray(spec.mask) != CellType.DEAD  # sparse f_standard
    # holds zeros at dead cells (engine/sparse.scatter_dense contract)
    np.testing.assert_allclose(
        np.asarray(sim_s.f_standard())[:, live],
        np.asarray(sim_d.f_standard())[:, live],
        rtol=3e-5, atol=1e-8)


@pytest.mark.multichip
def test_wk_gspmd_sharded_matches_single_device():
    """The runner's GSPMD path (mesh=): the outlet flux sum spans
    shards — XLA's partitioner must psum it and keep the replicated
    P_c consistent with the single-device run."""
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    from lbm_jax.parallel.mesh import lattice_mesh

    sim_1 = Simulation(spec, backend="xla")
    sim_m = Simulation(spec, backend="xla", mesh=lattice_mesh())
    for s in (sim_1, sim_m):
        s.run(max_steps=21, time_save=7, verbose=False)
    np.testing.assert_allclose(
        np.asarray(sim_m.wk), np.asarray(sim_1.wk), rtol=3e-6, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(sim_m.f_standard()), np.asarray(sim_1.f_standard()),
        rtol=3e-6, atol=1e-7)


def test_wk_checkpoint_roundtrip(tmp_path):
    """save_sim/restore carry the windkessel state: interrupted + resumed
    equals uninterrupted."""
    from lbm_jax.engine import checkpoint as ckpt

    spec = get_case("poiseuille", n=16, windkessel=_WK)
    sim_a = Simulation(spec, backend="xla")
    sim_a.run(max_steps=20, time_save=10, verbose=False)
    path = str(tmp_path / "wk.npz")
    ckpt.save_sim(path, sim_a)
    sim_b = Simulation(get_case("poiseuille", n=16, windkessel=_WK),
                       backend="xla")
    ckpt.restore(sim_b, path)
    np.testing.assert_allclose(np.asarray(sim_b.wk), np.asarray(sim_a.wk))
    for s in (sim_a, sim_b):
        s.run(max_steps=10, time_save=10, verbose=False)
    np.testing.assert_allclose(
        np.asarray(sim_b.wk), np.asarray(sim_a.wk), rtol=1e-7)
    np.testing.assert_allclose(
        np.asarray(sim_b.f_standard()), np.asarray(sim_a.f_standard()),
        rtol=1e-6, atol=1e-9)


def test_wk_halo_step_refuses_with_guidance():
    """The explicit shard_map halo step does not thread the P_c carry;
    it says so and names the GSPMD path that does."""
    from lbm_jax.parallel.halo import make_halo_step
    from lbm_jax.parallel.mesh import lattice_mesh

    cc = compile_case(get_case("poiseuille", n=16, windkessel=_WK))
    with pytest.raises(AssertionError, match="GSPMD"):
        make_halo_step(cc, lattice_mesh(), shard_axis=0)


def test_wk_pulsatile_outlet_tracks_flow():
    """Pulsatile inlet + RCR outlet (the physiological composition,
    curved_vessel windkessel=): the carried P_c moves with the flow
    waveform and everything stays finite."""
    spec = get_case("curved_vessel", n=32, nphase=4, period_steps=8,
                    windkessel=_WK)
    sim = Simulation(spec, backend="sparse")
    ps = []
    for _ in range(4):
        sim.run(max_steps=16, time_save=16, verbose=False)
        ps.append(float(np.asarray(sim.wk)[0]))
    assert np.all(np.isfinite(ps)) and ps[-1] > 0
    assert len({round(p, 9) for p in ps}) > 1, "P_c should evolve"
    assert np.isfinite(np.asarray(sim.f_standard())).all()


def test_wk_coronary_multi_outlet_dense_sparse():
    """Four independent RCR terminations on the coronary tree (main
    outlet + 3 z-plane sub-outlets — the clinical truncated-vasculature
    configuration replacing the reference's hard-coded outlet speeds,
    coronary.cu:795-942): the (4,) carried state stays ordered and
    dense/sparse agree through the multi-BC fixup chain."""
    wk = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3),
          (1e-4, 5e3, 4e-3), (1e-4, 5e3, 8e-3)]
    spec = get_case("coronary", shape=(48, 24, 40), radius=5,
                    windkessel=wk)
    assert sum(b.windkessel is not None for b in spec.boundaries) == 4
    sim_d = Simulation(spec, backend="xla")
    sim_s = Simulation(spec, backend="sparse")
    for s in (sim_d, sim_s):
        s.run(max_steps=80, time_save=40, verbose=False)
    assert np.asarray(sim_d.wk).shape == (4,)
    assert np.isfinite(np.asarray(sim_d.wk)).all()
    assert (np.asarray(sim_d.wk) > 0).all(), "inflow charges every RCR"
    np.testing.assert_allclose(
        np.asarray(sim_s.wk), np.asarray(sim_d.wk), rtol=3e-5, atol=1e-9)
    live = np.asarray(spec.mask) != CellType.DEAD
    np.testing.assert_allclose(
        np.asarray(sim_s.f_standard())[:, live],
        np.asarray(sim_d.f_standard())[:, live],
        rtol=3e-5, atol=1e-8)


def test_wk_validation_and_init():
    """Spec validation (rho_mode, positivity) and wk_init ordering."""
    from lbm_jax.engine.spec import PlaneBC

    with pytest.raises(AssertionError):
        PlaneBC(mask_value=3, axis=1, coord=5, normal=-1,
                rho_mode="extrapolate", u_mode="extrapolate",
                windkessel=(0.1, 10.0, 0.2))
    with pytest.raises(AssertionError):
        PlaneBC(mask_value=3, axis=1, coord=5, normal=-1,
                rho_mode="fixed", u_mode="extrapolate",
                windkessel=(0.1, -1.0, 0.2))
    spec = get_case("poiseuille", n=16, windkessel=_WK,
                    windkessel_p0=0.125)
    cc = compile_case(spec)
    w0 = wk_init(cc.bcs)
    assert w0.shape == (1,) and w0[0] == np.float32(0.125)
    sim = Simulation(spec, backend="xla")
    assert float(np.asarray(sim.wk)[0]) == np.float32(0.125)


@pytest.mark.parametrize("backend", ["xla", "sparse"])
def test_wk_stress_and_wss_thread_state(backend):
    """Simulation.stress()/wss() re-apply the BC fixups: on a windkessel
    case they must thread sim.wk (a plain pulled_state would assert) —
    on the sparse backend that exercises the wss_sparse wk route."""
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    sim = Simulation(spec, backend=backend)
    sim.run(max_steps=30, time_save=30, verbose=False)
    sigma, rho, _ = sim.stress()
    w = sim.wss()
    fl = np.asarray(spec.mask) == CellType.FLUID
    assert np.isfinite(np.asarray(sigma)).all()
    assert np.asarray(w).max() > 0
    acc = sim.wss_accumulator()
    acc.sample_sim(sim)
    assert np.isfinite(np.asarray(acc.tawss_field())[fl]).all()


def test_wk_pulsatile_coronary_sparse_matches_dense():
    """The clinical inlet: coronary pulsatile=(nphase, period) turns the
    reference's steady plug into a series NEE inlet composed with 4 RCR
    outlets — sparse vs dense through the time-varying waveform."""
    from backend_parity import assert_sparse_matches_dense

    wk = [(1e-4, 5e3, 2e-3), (1e-4, 5e3, 1e-3),
          (1e-4, 5e3, 4e-3), (1e-4, 5e3, 8e-3)]
    spec = get_case("coronary", shape=(48, 24, 40), radius=5,
                    windkessel=wk, pulsatile=(4, 8))
    assert_sparse_matches_dense(spec, nsteps=40, rtol=3e-5, atol=1e-8)
