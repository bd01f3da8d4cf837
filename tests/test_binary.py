"""Binary-liquid free-energy tests — engine/binary.py.

Anchors: the ANALYTIC planar interface profile tanh(x/xi) with
xi = sqrt(2 kappa/A) (fit after relaxation), order-parameter
conservation, the Laplace law against the ANALYTIC surface tension
sigma = (2 sqrt(2)/3) sqrt(kappa A), and spinodal decomposition of a
symmetric quench toward the +-1 bulk minima.
"""

import numpy as np
import pytest

from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.binary import (BinaryFluid, interface_width,
                                   surface_tension)
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType

_UNITS = UnitSystem(CH=1.0, C_U=1.0, C_rho=1.0)
_A, _K = 0.02, 0.08  # xi = 2.83 cells (a sub-2-cell interface is
# under-resolved: the discrete Laplacian widens it ~15%)


def _box(shape, tau=0.8):
    mask = np.full(shape, int(CellType.FLUID), np.int32)
    return CaseSpec(name="bin_box", shape=shape, tau=tau, units=_UNITS,
                    mask=mask, boundaries=[])


def test_planar_interface_is_tanh_with_analytic_width():
    """A pair of planar interfaces (periodic slab) relaxes to and HOLDS
    the analytic tanh profile: fitted width within 10% of
    sqrt(2 kappa/A), and phi is conserved."""
    n = 64
    shape = (n, 4, 4)
    xi = interface_width(_A, _K)
    x = np.arange(n, dtype=np.float64)
    phi0 = (np.tanh((x - 16) / xi) - np.tanh((x - 48) / xi) - 1.0)
    phi0 = np.broadcast_to(
        phi0[:, None, None].astype(np.float32), shape).copy()
    bf = BinaryFluid(_box(shape), A=_A, kappa=_K, phi_init=phi0)
    tot0 = bf.total_phi()
    bf.run(2000)
    phi = np.asarray(bf.phi())[:, 2, 2]
    assert np.isfinite(phi).all()
    assert bf.total_phi() == pytest.approx(tot0, abs=1e-3 * n * 16)
    # fit the first interface: phi = tanh((x - x0)/xi_fit) near x=16
    sel = (x > 8) & (x < 24)
    y = np.clip(phi[sel], -0.999, 0.999)
    z = np.arctanh(y)                 # linear in x with slope 1/xi_fit
    slope, _ = np.polyfit(x[sel], z, 1)
    xi_fit = 1.0 / slope
    assert xi_fit == pytest.approx(xi, rel=0.10), (xi_fit, xi)
    # bulks sit at the Landau minima (interior slab +1, exterior -1)
    assert abs(phi[32] - 1.0) < 0.02 and abs(phi[2] + 1.0) < 0.05


@pytest.mark.slow
def test_gibbs_thomson_droplet_matches_analytic_sigma():
    """A 3D droplet equilibrates to a UNIFORM chemical potential whose
    value is the Gibbs-Thomson shift mu0 = sigma / R (for this Landau
    potential, Delta p = 2 sigma/R = mu0 * Delta phi with
    Delta phi = 2) — measured against the ANALYTIC sigma to 15%.
    With the well-balanced force (-phi grad mu) the equilibrium force
    vanishes, so the capillary jump lives in the THERMODYNAMIC gauge
    (mu0), not the ideal-gas rho/3 — this is the right observable.
    Soft capillary stiffness: sigma ~ 4e-3-class parameters keep the
    explicit coupling stable (10x stiffer interfaces NaN the flow
    feedback by ~500 steps, measured)."""
    from lbm_jax.engine.binary import chemical_potential

    A, K = 0.002, 0.008               # xi = 2.83, sigma = 3.77e-3
    sig = surface_tension(A, K)
    xi = interface_width(A, K)
    n, R = 40, 8
    shape = (n, n, n)
    x, y, z = np.meshgrid(*(np.arange(n) - n / 2,) * 3,
                          indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    phi0 = np.tanh((R - r) / xi).astype(np.float32)
    bf = BinaryFluid(_box(shape), A=A, kappa=K, phi_init=phi0)
    bf.run(8000)      # mu equilibrates slowly (soft mobility); 4000
    # steps reads ~30% low while 8000 lands within a few percent
    phi = np.asarray(bf.phi())
    assert np.isfinite(phi).all()
    mu = np.asarray(chemical_potential(bf.phi(), A, K))
    c = n // 2
    mu_in = mu[c - 2:c + 2, c - 2:c + 2, c - 2:c + 2].mean()
    mu_out = np.concatenate([mu[:3].ravel(), mu[-3:].ravel()]).mean()
    assert (mu_in - mu_out) == pytest.approx(sig / R, rel=0.15), (
        mu_in - mu_out, sig / R)


def test_quench_sharpens_to_landau_minima_conserving_phi():
    """Half-deep domains (phi = +-0.5 blocks) sharpen to the +-1
    Landau minima (the fast LOCAL thermodynamics; small-noise spinodal
    GROWTH is physically ~1e-5/step at this box scale and is not a
    test-sized phenomenon) while conserving the order parameter."""
    shape = (32, 8, 4)
    x = np.arange(shape[0])
    phi0 = np.where((x > 8) & (x < 24), 0.5, -0.5).astype(np.float32)
    phi0 = np.broadcast_to(phi0[:, None, None], shape).copy()
    # flat domains take the stiff parameters fine (no curvature
    # feedback); the droplet physics needs the soft ones (see the
    # Gibbs-Thomson test)
    bf = BinaryFluid(_box(shape), A=0.08, kappa=0.08, gamma=0.5,
                     phi_init=phi0)
    tot0 = bf.total_phi()
    bf.run(7500)
    phi = np.asarray(bf.phi())
    assert np.isfinite(phi).all()
    assert phi.max() > 0.95 and phi.min() < -0.95, (phi.min(), phi.max())
    assert bf.total_phi() == pytest.approx(tot0, abs=0.2)
