"""Clinical plane diagnostics tests (engine/diagnostics.py): flux,
gauge pressure, and CFD-FFR on the steady windkessel pipe, where every
quantity has an independent prediction:

  * plane_flux at the outlet == the prescribed inlet parabola flux
    (mass conservation + sign/footprint convention),
  * plane_pressure at the outlet consumer plane == Q (Rp + Rd) (the
    RCR anchor, measured through the OTHER code path than
    tests/test_windkessel.py's rho mean),
  * the trans-pipe drop p_in - p_out > 0 lands near the analytic
    Hagen-Poiseuille gradient 4 nu u_max / R^2 per cell (loose: the
    eroded voxel radius is ambiguous at +-1 cell), and FFR < 1 follows
    by construction.
"""

import numpy as np

from lbm_jax.cases import get_case
from lbm_jax.engine.diagnostics import ffr, plane_flux, plane_pressure
from lbm_jax.engine.runner import Simulation

_WK = (5e-4, 24000.0, 2.5e-3)


def test_ffr_grades_a_stenosis():
    """The point of FFR: a proximal main-tube constriction (coronary
    stenosis=severity, smooth cosine throat) must raise the trans-tree
    pressure drop and lower FFR at EVERY outlet relative to the same
    tree without the lesion — all four outflows pass the throat."""
    from lbm_jax.engine.diagnostics import MMHG_PER_PA  # noqa: F401
    wk = [(2e-4, 5e3, 1e-3)] + [(2e-4, 5e3, 3e-3)] * 3
    kw = dict(shape=(64, 28, 44), radius=6, windkessel=wk)
    spec_h = get_case("coronary", **kw)
    spec_s = get_case("coronary", stenosis=0.35, **kw)
    # the throat actually constricts: min fluid cross-section well
    # below the healthy proximal one
    def min_area(spec):
        fl = np.asarray(spec.mask) == 4
        return int(fl[5:20].sum(axis=(1, 2)).min())
    assert min_area(spec_s) < 0.55 * min_area(spec_h)
    res = {}
    for name, spec in (("h", spec_h), ("s", spec_s)):
        sim = Simulation(spec, backend="xla")
        sim.run(max_steps=800, time_save=400, verbose=False)
        rho, u = (np.asarray(a) for a in sim.macro())
        assert np.isfinite(u).all()
        res[name] = [ffr(spec, rho, 0, 1 + k) for k in range(4)]
    for k in range(4):
        f_h, dp_h = res["h"][k]
        f_s, dp_s = res["s"][k]
        assert dp_s > 1.3 * dp_h, (k, dp_s, dp_h)
        assert f_s < f_h < 1.0, (k, f_s, f_h)


def _steady_sim():
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=1500, time_save=500, verbose=False)
    return spec, sim


def test_plane_diagnostics_on_windkessel_pipe():
    spec, sim = _steady_sim()
    rho, u = (np.asarray(a) for a in sim.macro())
    inlet = spec.boundaries[0]
    foot = np.take(np.asarray(spec.mask), inlet.coord,
                   axis=inlet.axis) == inlet.mask_value
    q_in = float(np.sum(np.asarray(inlet.u_field)[1][foot]))

    q_out = plane_flux(spec, u, 1)
    # the inlet parabola is prescribed on the INLET footprint; the
    # outlet footprint and consumer-plane placement differ by the
    # eroded rim, so mass balance across the two closes to ~5%
    np.testing.assert_allclose(q_out, q_in, rtol=0.08)
    # inlet plane: inward flux -> plane_flux (outward convention) < 0
    assert plane_flux(spec, u, 0) < 0

    p_out = plane_pressure(spec, rho, 1)
    # RCR self-consistency against the MEASURED outlet flux
    np.testing.assert_allclose(p_out, q_out * (_WK[0] + _WK[2]),
                               rtol=0.03)

    f, dp_mmhg = ffr(spec, rho, 0, 1, p_aortic_mmhg=90.0)
    assert 0.0 < f < 1.0 and dp_mmhg > 0
    # Hagen-Poiseuille at the MEASURED flux and the eroded pipe's own
    # cross-section (dp/dy = 8 nu Q / (pi R_eff^4)) is a LOWER BOUND
    # here, not the value: at Re ~ 25 the entrance length (~0.06 Re D
    # ~ 20 cells) exceeds the whole pipe, so the inlet-profile
    # redevelopment adds to the fully-developed drop (measured ~1.9x
    # at n=16). Bound it [1, 3]x — a sign+magnitude anchor that stays
    # meaningful without pretending developed flow.
    n, tau = 16, spec.tau
    nu = (tau - 0.5) / 3.0
    area = float((np.asarray(spec.mask)[:, n // 2, :] == 4).sum())
    r_eff = np.sqrt(area / np.pi)
    dp_lat = (plane_pressure(spec, rho, 0) - p_out)
    dp_hp = 8.0 * nu * q_out / (np.pi * r_eff**4) * (n - 5)
    assert 1.0 <= dp_lat / dp_hp <= 3.0, (dp_lat, dp_hp)
    # and the mmHg conversion is the same number through units
    np.testing.assert_allclose(
        dp_mmhg, dp_lat * spec.units.C_pre / 133.322, rtol=1e-6)
