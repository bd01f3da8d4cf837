"""Shan-Chen pseudopotential multiphase flow — single-component
liquid-vapor with surface tension, the second-to-last named member of
the reference's Lectures method family
(/root/reference/Lectures/3.shanchen.pdf is a documentation asset; the
reference ships single-phase code only).

The interparticle interaction is the classic nearest-neighbor
pseudopotential sum over the D3Q19 stencil,

    F(x) = -G psi(x) sum_i w_i psi(x + e_i) e_i ,
    psi(rho) = 1 - exp(-rho)                      (Shan & Chen 1993)

applied through this repo's per-cell Guo forcing (step.make_step_force
— the modern thermodynamically-consistent coupling, vs the original
velocity-shift form), so multiphase composes with the same machinery
as buoyancy/IBM and the whole scan stays jit/scan/grad-friendly.

Bulk equation of state (c_s^2 = 1/3):  p = rho/3 + (G/6) psi(rho)^2.
dp/drho = 1/3 + (G/3) psi psi' turns non-monotone below the critical
coupling: psi psi' peaks at 1/4 (rho = ln 2), so G_c = -4 — a uniform
fluid at rho ~ ln 2 phase-separates for G < -4 into liquid/vapor bulks
whose MECHANICAL equilibrium (equal p across a flat interface) and
Laplace pressure jump (dp = 2 sigma / R for a 3D droplet) the tests
measure from this EOS.

Periodic-box physics (mask all-FLUID, no boundaries): wall adhesion /
contact angles (a psi value on wall cells) are a natural follow-on and
not yet wired.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.engine.spec import CaseSpec


def psi_of(rho):
    """Shan-Chen pseudopotential psi(rho) = 1 - e^{-rho} (bounded, the
    standard choice whose EOS gives G_c = -4 at c_s^2 = 1/3)."""
    return 1.0 - jnp.exp(-rho)


def sc_force(rho, G: float):
    """(3, X, Y, Z) interaction force field from the density field:
    F = -G psi sum_i w_i psi(x + e_i) e_i (18 rolls; pairwise
    antisymmetric, so the box total is zero — momentum-conserving)."""
    psi = psi_of(rho)
    acc = [jnp.zeros_like(rho) for _ in range(3)]
    for i in range(1, D3Q19.Q):
        e = [int(v) for v in D3Q19.E[i]]
        axes = [a for a, s in enumerate(e) if s]
        nb = jnp.roll(psi, shift=[-e[a] for a in axes], axis=axes)
        w = float(D3Q19.W[i])
        for a in axes:
            acc[a] = acc[a] + (w * e[a]) * nb
    f = jnp.stack(acc)
    return (-G) * psi[None] * f


def eos_pressure(rho, G: float):
    """Bulk EOS p(rho) = rho/3 + (G/6) psi^2 — equal across coexisting
    bulks at mechanical equilibrium (flat interface)."""
    return rho / 3.0 + (G / 6.0) * psi_of(rho) ** 2


class ShanChen:
    """Single-component multiphase on a (typically fully periodic)
    case: per step the density's pseudopotential force rebuilds and
    drives the flow through the runtime-force step — the same
    two-field explicit coupling shape as the thermal route, with the
    force a function of the FLOW's own density."""

    def __init__(self, spec: CaseSpec, G: float, rho_init=None):
        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.step import initial_f, make_step_force

        assert spec.force is None, "the SC force replaces CaseSpec.force"
        self.spec = spec
        self.G = float(G)
        self.cc = compile_case(spec)
        self._step = make_step_force(self.cc)
        if rho_init is None:
            self.f = initial_f(self.cc)
        else:
            from lbm_jax.core.lattice import phi

            rho0 = jnp.asarray(rho_init, jnp.float32)
            u0 = jnp.zeros((3,) + tuple(spec.shape), jnp.float32)
            self.f = rho0[None] * phi(u0)
        self.t = 0
        self._scan = {}

    def run(self, n_steps: int):
        n_steps = int(n_steps)
        if n_steps not in self._scan:
            G = self.G

            def scan_fn(f, t0):
                def body(f, t):
                    rho = jnp.sum(f, axis=0)
                    F = sc_force(rho, G)
                    f, _, _ = self._step(f, t, F)
                    return f, None

                f, _ = jax.lax.scan(
                    body, f, t0 + jnp.arange(n_steps, dtype=jnp.int32))
                return f

            self._scan[n_steps] = jax.jit(scan_fn)
        self.f = self._scan[n_steps](self.f, jnp.int32(self.t))
        self.t += n_steps

    def rho(self):
        return jnp.sum(self.f, axis=0)

    def macro(self):
        """(rho, u) with the CURRENT interaction force's half-shift
        (Guo velocity definition)."""
        from lbm_jax.engine.step import half_force_shift

        rho = self.rho()
        mom = jnp.tensordot(
            jnp.asarray(D3Q19.E.T.astype(np.float32)), self.f,
            axes=([1], [0]), precision=jax.lax.Precision.HIGHEST)
        mom = half_force_shift(mom, sc_force(rho, self.G))
        u = mom / jnp.where(rho == 0, 1.0, rho)[None]
        return rho, u

    def pressure(self):
        """Bulk EOS pressure field (valid away from interfaces)."""
        return eos_pressure(self.rho(), self.G)

    def total_mass(self) -> float:
        return float(np.asarray(self.rho(), np.float64).sum())


__all__ = ["ShanChen", "sc_force", "psi_of", "eos_pressure"]
