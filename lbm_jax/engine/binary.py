"""Binary-liquid free-energy model — the LAST named member of the
reference's Lectures method family
(/root/reference/Lectures/4.binaryliquid.pdf is a documentation asset;
the reference ships single-phase code only). Two immiscible liquids of
equal density tracked by an order parameter phi in [-1, 1] with
Landau free energy

    f(phi) = A (-phi^2/2 + phi^4/4) + kappa/2 |grad phi|^2 ,

giving the chemical potential mu = A (phi^3 - phi) - kappa lap(phi),
the analytic planar interface phi = tanh(x / xi) with
xi = sqrt(2 kappa / A), and surface tension
sigma = (2 sqrt(2) / 3) sqrt(kappa A).

Discretization (the standard two-distribution LBM pairing):
  - the FLOW is the existing D3Q19 engine with the interfacial force
    F = -phi grad(mu) — the WELL-BALANCED potential form: measured, the
    algebraically-equivalent mu grad(phi) discretization pumps spurious
    currents that EVAPORATE sharpened domains by ~6000 steps, while
    -phi grad(mu) is exactly zero wherever mu is uniform (every
    equilibrium) and holds them indefinitely — applied through the
    per-cell Guo runtime-force step (same composition machinery as
    buoyancy / IBM / Shan-Chen). Corollary: the capillary pressure
    jump lives in the THERMODYNAMIC gauge (the uniform Gibbs-Thomson
    mu0 = sigma/R), not in rho/3. Keep sigma ~ 4e-3-class (A ~ 2e-3,
    kappa ~ 8e-3): 10x stiffer droplet interfaces NaN the explicit
    flow feedback (measured);
  - the ORDER PARAMETER rides a D3Q7 distribution relaxing toward the
    Cahn-Hilliard equilibrium
        g_i^eq = w_i Gamma mu / c_s2 + w_i phi e_i.u / c_s2   (i > 0)
        g_0^eq = phi - sum_{i>0} g_i^eq |_{u-independent part}
    whose moments are (phi, phi u, Gamma mu c_s2 I), so Chapman-Enskog
    yields  d phi/dt + div(phi u) = M lap(mu),
    M = Gamma (tau_g - 1/2) c_s2  (c_s2 = 1/4 for this weight set).
Gradients/Laplacians of phi and mu are lattice central differences
(periodic-box physics; walls/wetting are a follow-on, like Shan-Chen's).

Stability: the CH update is an explicit biharmonic step — gamma = 1
NaNs a 3D quench (kappa M lap^2 exceeds the CFL); gamma = 0.3 at the
test's A/kappa is comfortably inside (measured). Spinodal GROWTH of a
small-noise quench is physically slow here (sigma_k = M(A k^2 -
kappa k^4) peaks ~1e-5/step at the box scale), so the quench test
asserts the fast local Landau sharpening instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.engine.scalar import _E7, _OPP7, _Q7, _W7
from lbm_jax.engine.spec import CaseSpec

_INV_CS2 = 4.0     # 1 / c_s^2 of the D3Q7 weight set (1/4, 1/8 x 6)


def grad_c(field):
    """(3, ...) central-difference gradient (periodic)."""
    return jnp.stack([
        0.5 * (jnp.roll(field, -1, a) - jnp.roll(field, +1, a))
        for a in range(3)])


def lap_c(field):
    """Central 7-point Laplacian (periodic)."""
    out = -6.0 * field
    for a in range(3):
        out = out + jnp.roll(field, -1, a) + jnp.roll(field, +1, a)
    return out


def chemical_potential(phi, A: float, kappa: float):
    return A * (phi ** 3 - phi) - kappa * lap_c(phi)


def interface_width(A: float, kappa: float) -> float:
    return float(np.sqrt(2.0 * kappa / A))


def surface_tension(A: float, kappa: float) -> float:
    return float(2.0 * np.sqrt(2.0) / 3.0 * np.sqrt(kappa * A))


def _g_eq(phi, mu, u, gamma: float):
    """(7, ...) Cahn-Hilliard equilibrium (moments phi / phi u /
    Gamma mu c_s2 I)."""
    eqs = []
    rest = phi
    for i in range(1, _Q7):
        a = int(np.argmax(np.abs(_E7[i])))
        s = float(_E7[i][a])
        gi = _W7[i] * _INV_CS2 * (gamma * mu + s * phi * u[a])
        eqs.append(gi)
        rest = rest - gi
    return jnp.stack([rest] + eqs)


class BinaryFluid:
    """Two-liquid free-energy flow on a (typically fully periodic)
    case: per step mu and F = mu grad(phi) rebuild from the live phi,
    the D3Q19 flow advances under F (runtime-force step), and the D3Q7
    order-parameter distribution streams + relaxes toward the CH
    equilibrium in the new velocity."""

    def __init__(self, spec: CaseSpec, A: float = 0.04,
                 kappa: float = 0.04, gamma: float = 0.3,
                 tau_g: float = 0.8, phi_init=None):
        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.step import initial_f, make_step_force

        assert spec.force is None
        self.spec = spec
        self.A, self.kappa, self.gamma = float(A), float(kappa), float(gamma)
        self.tau_g = float(tau_g)
        self.cc = compile_case(spec)
        self._step = make_step_force(self.cc)
        self.f = initial_f(self.cc)
        phi0 = (jnp.zeros(tuple(spec.shape), jnp.float32)
                if phi_init is None
                else jnp.asarray(phi_init, jnp.float32))
        u0 = jnp.zeros((3,) + tuple(spec.shape), jnp.float32)
        mu0 = chemical_potential(phi0, self.A, self.kappa)
        self.g = _g_eq(phi0, mu0, u0, self.gamma)
        self.t = 0
        self._scan = {}

    def _one(self, f, g, t):
        phi = jnp.sum(g, axis=0)
        mu = chemical_potential(phi, self.A, self.kappa)
        F = -phi[None] * grad_c(mu)   # well-balanced (see module doc)
        f, _, u = self._step(f, t, F)
        # stream the order parameter (periodic pulls) + BGK toward the
        # CH equilibrium in the NEW velocity
        pulled = [g[0]]
        for i in range(1, _Q7):
            e = [int(v) for v in _E7[i]]
            axes = [a for a, s in enumerate(e) if s]
            pulled.append(jnp.roll(g[i], shift=[e[a] for a in axes],
                                   axis=axes))
        pulled = jnp.stack(pulled)
        phi_n = jnp.sum(pulled, axis=0)
        mu_n = chemical_potential(phi_n, self.A, self.kappa)
        geq = _g_eq(phi_n, mu_n, u, self.gamma)
        g = pulled - (pulled - geq) / self.tau_g
        return f, g

    def run(self, n_steps: int):
        n_steps = int(n_steps)
        if n_steps not in self._scan:
            def scan_fn(f, g, t0):
                def body(carry, t):
                    f, g = carry
                    f, g = self._one(f, g, t)
                    return (f, g), None

                (f, g), _ = jax.lax.scan(
                    body, (f, g),
                    t0 + jnp.arange(n_steps, dtype=jnp.int32))
                return f, g

            self._scan[n_steps] = jax.jit(scan_fn)
        self.f, self.g = self._scan[n_steps](self.f, self.g,
                                             jnp.int32(self.t))
        self.t += n_steps

    def phi(self):
        return jnp.sum(self.g, axis=0)

    def rho(self):
        return jnp.sum(self.f, axis=0)

    def pressure(self):
        """Flow (ideal-gas) pressure rho/3 — the Laplace-jump reader
        for equal-density binary liquids."""
        return self.rho() / 3.0

    def total_phi(self) -> float:
        return float(np.asarray(self.phi(), np.float64).sum())


__all__ = ["BinaryFluid", "chemical_potential", "interface_width",
           "surface_tension", "grad_c", "lap_c"]
