"""Two-way coupled thermal flow: Boussinesq natural convection.

The reference is an isothermal solver (its four .cu programs carry no
temperature; /root/reference/README.md:2 excludes body forces entirely),
yet buoyancy-driven flow is the canonical second application of LBM and
the standard extension of exactly the machinery this repo already has:
the D3Q7 advection-diffusion distribution (engine/scalar.py) carries
temperature, and the Guo forcing scheme (engine/step.guo_source) feeds
it back into the D3Q19 momentum equation as the Boussinesq buoyancy

    F(x, t) = buoyancy * (c(x, t) - c_ref),    buoyancy = g_vec * beta

(lattice units; g_vec the gravity vector, beta the thermal expansion
coefficient — only their product is observable, so the API takes the
product). The mean-density gravity rho0*g is absorbed into the pressure
gauge as usual in the Boussinesq approximation, so c = c_ref exerts no
force and CaseSpec.force (if any) remains the constant base.

Numerically the coupling is the explicit two-distribution scheme: per
step the flow advances with the force field built from the PREVIOUS
step's temperature (one sum over the 7 g channels + one FMA per cell),
then the scalar advects in the NEW velocity (the same ordering as
CoupledTransport, which this class extends with the feedback term and
with isothermal walls via scalar.dirichlet_walls' anti-bounce-back).
Both half-steps stay in ONE fused lax.scan body, so a thermal step
costs the flow step + the ADE step + one 7-channel reduction.

Dimensionless groups (H = wall-to-wall distance in cells, walls half-way
between the wall and fluid cell layers):

    Pr = nu / kappa,   Ra = |buoyancy| * dT * H^3 / (nu * kappa)

with nu = (tau - 1/2)/3 and kappa = (tau_g - 1/2)/4 (the D3Q7 weight
set's c_s^2 = 1/4, scalar.tau_g_of). Validation anchors
(tests/test_thermal.py):
  - pure conduction between isothermal walls -> the exact linear
    profile with half-way wall placement (Nu = 1),
  - a uniform-temperature box under buoyancy == the constant-force Guo
    path bit-closely (the field-force code path degenerates correctly),
  - Rayleigh-Benard onset straddles the rigid-rigid critical number
    Ra_c = 1708 (perturbation kinetic energy decays at Ra well below,
    grows well above),
  - the differentially heated square cavity lands on de Vahl Davis'
    benchmark Nusselt numbers (Ra = 1e3: Nu = 1.118).

Case builders for both canonical geometries live in cases/thermal.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.engine.scalar import (ScalarTransport, _project,
                                   _transport_pass, bc_geometry,
                                   dirichlet_walls, phi7, tau_g_of)
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.geometry.mask import CellType


class BuoyantTransport:
    """Boussinesq-coupled flow + temperature on one case's geometry.

    spec: the flow CaseSpec (mask, walls, any plane BCs, collision
       operator, closures — the buoyancy composes with all of them the
       way CaseSpec.force does; plane-BC NEE fixups see only the static
       cc.force, see step.make_step_force).
    D / tau_g: lattice thermal diffusivity kappa (one of the two).
    buoyancy: 3-vector g_vec * beta per unit temperature (lattice
       units) — the force field is buoyancy * (c - c_ref) at fluid
       cells.
    c_ref: the reference temperature exerting zero force.
    wall_c: (X, Y, Z) isothermal wall values (NaN = adiabatic), per
       scalar.dirichlet_walls.
    inlet_c / source / c0: as in ScalarTransport (plane-BC
       temperatures, volumetric heating, initial field).
    div_fix: default OFF here — the defect derivation assumes pure
       bounce-back walls (see ScalarTransport.wall_c note) and natural-
       convection velocities are far below the advective regimes the
       fix targets.
    f0: optional initial flow state (e.g. a restart).
    mesh / shard_axis: GSPMD decomposition over a jax.sharding.Mesh —
       both states (f, g) and every per-cell static shard along a
       BC-free lattice axis and XLA's SPMD partitioner inserts the
       one-deep halo exchanges, exactly the CoupledTransport mesh=
       mechanism (the buoyancy force field is built from the sharded c
       by elementwise ops, so it inherits the sharding for free).
    """

    def __init__(self, spec: CaseSpec, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 buoyancy=(0.0, 0.0, 0.0), c_ref: float = 0.0,
                 wall_c=None, inlet_c: Optional[dict] = None,
                 source: float = 0.0, c0=None, div_fix: bool = False,
                 f0=None, mesh=None,
                 shard_axis: Optional[int] = None):
        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.step import has_windkessel, initial_f

        assert (D is None) != (tau_g is None), (
            "give exactly one of D (lattice diffusivity) or tau_g")
        self.tau_g = float(tau_g_of(D) if D is not None else tau_g)
        assert self.tau_g > 0.5, "tau_g must exceed 1/2 (D > 0)"
        self.spec = spec
        self.cc = compile_case(spec)
        assert not has_windkessel(self.cc.bcs), (
            "windkessel outlets are not wired for the buoyant route")
        if self.cc.bcs and np.any(np.asarray(buoyancy) != 0.0):
            # make_step_force keeps the STATIC cc.force in the plane-BC
            # NEE fixups' half-shift — second-order at an open plane,
            # but not silent (ADVICE r4)
            print("[lbm_jax] BuoyantTransport: plane BCs present — "
                  "their NEE fixups use the static CaseSpec.force, not "
                  "the per-cell buoyancy (a second-order approximation "
                  "at open planes; closed thermal boxes are exact)",
                  flush=True)
        mask = np.asarray(spec.mask)
        blocking = (mask == CellType.WALL) | (mask == CellType.MOVING)
        self.fluid = jnp.asarray(mask == CellType.FLUID)
        from lbm_jax.engine.scalar import _E7, _Q7
        nbr = [np.roll(blocking, shift=tuple(int(v) for v in _E7[i]),
                       axis=(0, 1, 2)) for i in range(1, _Q7)]
        self.nbr_block = jnp.asarray(np.stack(nbr))
        self.blocked_axes = jnp.asarray(np.stack(
            [nbr[2 * a] | nbr[2 * a + 1] for a in range(3)]))
        self.omega = np.float32(1.0 - 1.0 / self.tau_g)
        inlet_c = dict(inlet_c or {})
        self._bc_geo = bc_geometry(spec)
        self._bcs = [(g[0], g[3], g[4], inlet_c.pop(k, None))
                     for k, g in enumerate(self._bc_geo)]
        assert not inlet_c, f"inlet_c names absent boundaries: {inlet_c}"
        self.div_fix = bool(div_fix)
        self.source = float(source)
        self.dirichlet = (None if wall_c is None
                          else dirichlet_walls(mask, wall_c))
        self.buoyancy = np.asarray(buoyancy, np.float32)
        assert self.buoyancy.shape == (3,)
        self.c_ref = np.float32(c_ref)
        self.base_force = (None if spec.force is None else
                           np.asarray(spec.force, np.float32))

        self.f = initial_f(self.cc) if f0 is None else jnp.asarray(f0)
        if c0 is None:
            self.g = jnp.zeros((7,) + tuple(spec.shape), jnp.float32)
        else:
            u0 = _project(jnp.asarray(self.cc.u0), self.blocked_axes)
            self.g = jnp.where(self.fluid[None],
                               jnp.asarray(c0, jnp.float32)[None]
                               * phi7(u0), 0.0)
        self.t = 0
        self._scan_cache = {}
        if mesh is not None:
            self._shard(mesh, shard_axis)

    def _shard(self, mesh, shard_axis: Optional[int]):
        from lbm_jax.parallel.mesh import (free_axis, lattice_sharding,
                                           shard_case)

        axis = free_axis(self.spec) if shard_axis is None else shard_axis
        put = lambda x, lead: (None if x is None else jax.device_put(  # noqa: E731
            x, lattice_sharding(axis=axis, mesh=mesh, leading=lead)))
        self.f = put(self.f, 1)
        self.g = put(self.g, 1)
        self.nbr_block = put(self.nbr_block, 1)
        self.blocked_axes = put(self.blocked_axes, 1)
        self.fluid = put(self.fluid, 0)
        if self.dirichlet is not None:
            self.dirichlet = tuple(put(a, 1) for a in self.dirichlet)
        self.cc = shard_case(self.cc, mesh, axis)

    @property
    def fields(self):
        """Big per-cell statics as jit ARGUMENTS (the HLO-constant
        argument of ScalarTransport.fields), the flow's compiled case
        (a pytree) included."""
        return (self.nbr_block, self.blocked_axes, self.fluid,
                self.dirichlet, self.cc)

    def _force_field(self, c, fluid):
        """(3, X, Y, Z) Boussinesq force: buoyancy * (c - c_ref) at
        fluid cells (+ the case's static base force, if any)."""
        dc = jnp.where(fluid, c - self.c_ref, 0.0)
        fb = self.buoyancy.reshape(3, 1, 1, 1) * dc[None]
        if self.base_force is not None:
            fb = fb + self.base_force.reshape(3, 1, 1, 1)
        return fb

    def _step(self, f, t, g, fields):
        from lbm_jax.engine.scalar import _defect
        from lbm_jax.engine.step import make_step_force

        nbr_block, blocked_axes, fluid, dirichlet, cc = fields
        c_prev = jnp.sum(g, axis=0)
        force = self._force_field(c_prev, fluid)
        flow_step = make_step_force(cc)
        f_new, rho, u = flow_step(f, t, force)
        u_proj = _project(u, blocked_axes)
        phi = phi7(u_proj)
        comp = None
        if self.div_fix:
            comp = jnp.where(
                fluid, -_defect(u_proj, nbr_block, self._bc_geo), 0.0)
        g_new, c = _transport_pass(g, t, phi, nbr_block, self._bcs,
                                   self.omega, self.tau_g, comp,
                                   self.source, fluid, dirichlet)
        return f_new, g_new, c, u

    def run(self, n_steps: int, record_energy: bool = False):
        """Advance flow + temperature n_steps in one jitted scan.
        record_energy: sample the domain kinetic energy sum(u^2 at
        fluid cells) EVERY step and return the (n_steps,) series (the
        Rayleigh-Benard onset diagnostic), else None."""
        key = (int(n_steps), bool(record_energy))
        if key not in self._scan_cache:
            def scan_fn(f, g, t0, fields):
                def body(carry, t):
                    f, g = carry
                    f, g, c, u = self._step(f, t, g, fields)
                    ys = (jnp.sum(jnp.where(fields[2][None],
                                            u * u, 0.0))
                          if record_energy
                          else jnp.zeros((), jnp.float32))
                    return (f, g), ys

                return jax.lax.scan(
                    body, (f, g),
                    t0 + jnp.arange(n_steps, dtype=jnp.int32))

            self._scan_cache[key] = jax.jit(scan_fn)
        (self.f, self.g), series = self._scan_cache[key](
            self.f, self.g, jnp.int32(self.t), self.fields)
        self.t += n_steps
        return np.asarray(series) if record_energy else None

    def macro(self):
        """(rho, u) with the CURRENT buoyant force's half-shift — the
        static macro_fields would miss the per-cell F/2 term."""
        from lbm_jax.core.lattice import D3Q19
        from lbm_jax.engine.step import half_force_shift

        c = jnp.sum(self.g, axis=0)
        force = self._force_field(c, self.fluid)
        rho = jnp.sum(self.f, axis=0)
        mom = jnp.tensordot(
            jnp.asarray(D3Q19.E.T.astype(np.float32)), self.f,
            axes=([1], [0]), precision=jax.lax.Precision.HIGHEST)
        mom = half_force_shift(mom, force)
        u = mom / jnp.where(rho == 0, 1.0, rho)[None]
        rho = jnp.where(self.fluid, rho, self.cc.rho0)
        u = jnp.where(self.fluid[None], u, self.cc.u0)
        return rho, u

    concentration = ScalarTransport.concentration
    total = ScalarTransport.total

    # -- checkpoint / resume -----------------------------------------

    def save(self, path: str) -> None:
        """Atomic npz checkpoint of the coupled state (f, g, t) — the
        thermal twin of engine/checkpoint.save_sim (same temp-file
        rename crash atomicity; long natural-convection runs are many
        diffusion times)."""
        import os

        tmp = path + ".tmp"
        np.savez_compressed(
            tmp, f=np.asarray(self.f), g=np.asarray(self.g),
            t=np.int64(self.t),
            case=np.bytes_(self.spec.name.encode()))
        actual = tmp if tmp.endswith(".npz") else tmp + ".npz"
        os.replace(actual, path)

    def restore(self, path: str) -> None:
        """Restore a checkpoint written by save, verifying case
        identity; the resumed trajectory is bit-identical to the
        uninterrupted one (tests/test_thermal.py round-trip)."""
        with np.load(path) as d:
            case = bytes(d["case"]).decode()
            if case != self.spec.name:
                raise ValueError(
                    f"checkpoint is for case {case!r}, this transport "
                    f"is {self.spec.name!r}")
            shp = tuple(self.spec.shape)
            if (d["f"].shape != (19,) + shp
                    or d["g"].shape != (7,) + shp):
                raise ValueError(
                    f"checkpoint shapes f{d['f'].shape} / "
                    f"g{d['g'].shape} do not match this case's "
                    f"{shp} — a same-named checkpoint from a "
                    f"different resolution (ADVICE r4: fail here, not "
                    f"with a cryptic jit shape error later)")
            self.f = jnp.asarray(d["f"])
            self.g = jnp.asarray(d["g"])
            self.t = int(d["t"])

    # -- diagnostics -------------------------------------------------

    def nusselt_profile(self, hot_axis: int, kappa: float, dT: float,
                        H: float):
        """Per-plane Nusselt number along `hot_axis`: the total heat
        flux (advective u_a*c + diffusive -kappa dc/da, central
        difference) through each interior lattice plane, normalized by
        the pure-conduction flux kappa*dT/H per unit wall area. At
        steady state the profile is plane-independent (a built-in
        self-check); its mean is THE cavity Nusselt number compared to
        de Vahl Davis. Returns (planes, Nu_per_plane)."""
        c = np.asarray(self.concentration(), np.float64)
        _, u = self.macro()
        ua = np.asarray(u[hot_axis], np.float64)
        fluid = np.asarray(self.fluid)
        n = c.shape[hot_axis]
        # per-wall-area normalization: count fluid cells per plane
        planes, nu = [], []
        for x in range(2, n - 2):
            sl = [slice(None)] * 3
            sl[hot_axis] = x
            slp = list(sl)
            slp[hot_axis] = x + 1
            slm = list(sl)
            slm[hot_axis] = x - 1
            adv = (ua[tuple(sl)] * c[tuple(sl)])[fluid[tuple(sl)]].sum()
            dif = (-kappa * 0.5
                   * (c[tuple(slp)] - c[tuple(slm)]))[
                       fluid[tuple(sl)]].sum()
            area = fluid[tuple(sl)].sum()
            if area == 0:
                continue
            planes.append(x)
            nu.append((adv + dif) / (area * kappa * dT / H))
        return np.asarray(planes), np.asarray(nu)


__all__ = ["BuoyantTransport"]
