"""Shan-Chen multiphase tests — engine/multiphase.py.

Anchors: sub-critical stability / super-critical phase separation
around the analytic G_c = -4 (psi = 1 - e^{-rho}, c_s^2 = 1/3), flat-
interface mechanical equilibrium (equal bulk EOS pressure), the 3D
Laplace law (dp linear in 1/R with positive surface tension), mass and
momentum conservation of the pairwise-antisymmetric interaction.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.multiphase import ShanChen, eos_pressure
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)


def _box(shape, tau=1.0):
    mask = np.full(shape, int(CellType.FLUID), np.int32)
    return CaseSpec(name="sc_box", shape=shape, tau=tau, units=_UNITS,
                    mask=mask, boundaries=[])


def _noisy_rho(shape, rho0=np.log(2.0), amp=0.01, seed=0):
    rng = np.random.default_rng(seed)
    return (rho0 * (1.0 + amp * rng.standard_normal(shape))
            ).astype(np.float32)


def test_subcritical_stays_uniform_supercritical_separates():
    """The analytic spinodal: at rho ~ ln 2 the uniform state is
    stable for G > G_c = -4 and separates below it."""
    shape = (24, 4, 4)
    rho0 = _noisy_rho(shape)
    sub = ShanChen(_box(shape), G=-3.0, rho_init=rho0)
    sup = ShanChen(_box(shape), G=-5.0, rho_init=rho0)
    for s in (sub, sup):
        s.run(1500)
    spread_sub = float(np.ptp(np.asarray(sub.rho())))
    spread_sup = float(np.ptp(np.asarray(sup.rho())))
    assert spread_sub < 0.05, spread_sub          # noise decays
    assert spread_sup > 0.5, spread_sup           # two phases form
    assert np.isfinite(np.asarray(sup.rho())).all()


def test_flat_interface_mechanical_equilibrium():
    """1D slab: liquid and vapor bulks coexist at EQUAL EOS pressure
    (mechanical equilibrium across the flat interface) and distinct
    densities."""
    shape = (48, 4, 4)
    x = np.arange(shape[0])
    rho0 = np.where((x > 12) & (x < 36), 1.8, 0.16).astype(np.float32)
    rho0 = np.broadcast_to(rho0[:, None, None], shape).copy()
    sc = ShanChen(_box(shape), G=-5.0, rho_init=rho0)
    sc.run(4000)
    rho = np.asarray(sc.rho())[:, 2, 2]
    assert np.isfinite(rho).all()
    rho_l = rho[20:28].mean()                     # liquid bulk
    rho_v = np.concatenate([rho[:6], rho[-6:]]).mean()
    assert rho_l / rho_v > 3.0, (rho_l, rho_v)
    p_l = float(eos_pressure(jnp.float32(rho_l), -5.0))
    p_v = float(eos_pressure(jnp.float32(rho_v), -5.0))
    np.testing.assert_allclose(p_l, p_v, rtol=0.03)
    # mass conserved through the separation (fp32 rounding walk over
    # 4000 steps; no systematic leak)
    tot0 = float(np.asarray(rho0, np.float64).sum())
    np.testing.assert_allclose(sc.total_mass(), tot0, rtol=2e-4)


@pytest.mark.slow
def test_laplace_law_3d():
    """Droplets of radius 6/8/10 in a 40^3 periodic box: the inside-
    outside EOS pressure jump is linear in 1/R (dp = 2 sigma / R) with
    positive surface tension and a good fit."""
    dps, invR = [], []
    for R in (6, 8, 10):
        n = 40
        shape = (n, n, n)
        x, y, z = np.meshgrid(*(np.arange(n) - n / 2,) * 3,
                              indexing="ij")
        r = np.sqrt(x * x + y * y + z * z)
        rho0 = np.where(r < R, 1.8, 0.16).astype(np.float32)
        sc = ShanChen(_box(shape), G=-5.0, rho_init=rho0)
        sc.run(3000)
        rho = np.asarray(sc.rho())
        assert np.isfinite(rho).all()
        c = n // 2
        p_in = float(eos_pressure(
            jnp.float32(rho[c - 2:c + 2, c - 2:c + 2,
                            c - 2:c + 2].mean()), -5.0))
        p_out = float(eos_pressure(
            jnp.float32(np.concatenate(
                [rho[:3].ravel(), rho[-3:].ravel()]).mean()), -5.0))
        dps.append(p_in - p_out)
        invR.append(1.0 / R)
    dps, invR = np.asarray(dps), np.asarray(invR)
    assert (dps > 0).all(), dps
    slope, icpt = np.polyfit(invR, dps, 1)
    sigma = slope / 2.0
    assert sigma > 0, sigma
    fit = np.polyval((slope, icpt), invR)
    resid = np.abs(fit - dps).max() / dps.max()
    assert resid < 0.1, (dps, fit)


def test_momentum_conserved_in_periodic_box():
    """The interaction is pairwise antisymmetric: total momentum in a
    periodic box stays at rounding scale through phase separation."""
    shape = (16, 16, 4)
    sc = ShanChen(_box(shape), G=-5.0,
                  rho_init=_noisy_rho(shape, seed=3))
    sc.run(800)
    rho, u = sc.macro()
    mom = np.asarray((rho[None] * u)).sum(axis=(1, 2, 3))
    assert np.abs(mom).max() < 1e-3, mom
