"""Passive scalar transport: advection-diffusion LBM (D3Q7) on the
converged flow — contrast washout, virtual bolus curves, residence time.

The reference stops at velocity/pressure output (coronary.cu:948-1011);
the clinical questions downstream of a coronary simulation — where does
contrast linger, how fast does a drug wash out, which recirculation
zones have long residence times (the thrombosis marker that complements
OSI) — are advection-diffusion problems on the computed flow. This
module solves  dc/dt + u.grad(c) = D lap(c) + s  with a second lattice
distribution g over the D3Q7 subset (rest + 6 axis directions — the
first 7 entries of this repo's D3Q19 ordering, core/lattice.py):

    g_i^eq = w_i c (1 + e_i.u / c_s2),   w = (1/4, 1/8 x 6), c_s2 = 1/4
    D = c_s2 (tau_g - 1/2)

One-way coupling ("frozen field"): hemodynamics converges first on ANY
backend, then transport scans over the frozen macro u — the standard
regime (tracer concentrations do not alter blood rheology). That makes
the scalar step mostly PRECOMPUTED: the equilibrium factor
phi7_i = w_i (1 + 4 e_i.u) is a static (7, X, Y, Z) array, so collide
is one multiply-add per channel (g' = g - (g - c*phi7)/tau_g), and the
7-channel pull-stream reuses the flow engine's fused wall handling
(pull_one + bounce-back against the SAME wall set — zero normal scalar
flux through impermeable walls, exactly conservative).

Boundary planes reuse the flow BCs' consumer-plane geometry
(engine/compile.compile_bc semantics): in D3Q7 exactly ONE direction
crosses a plane BC, and its pulled value gets the NEE-style fixup
val = w_i c* (1 + 4 e_i.u) + (g_F - g_F^eq)(1 - 1/tau_g) with c* the
prescribed inlet concentration (a float, or a callable of the traced
step for a time-gated bolus) or the zero-gradient extrapolation
c* = c_F at outlets.

Residence time / mean age: `source` adds s w_i per fluid cell per step;
with s = 1 and inlet c* = 0 the steady c field IS the mean age
(in steps) of fluid at each cell — u.grad(a) = D lap(a) + 1.

Physical units: D_lat = units.to_lattice_diffusivity(D_phys); the
washout curves are per-step (= per C_T seconds) plane means.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.engine.step import _plane_slicer, pull_one
from lbm_jax.geometry.mask import CellType

_Q7 = 7
_E7 = D3Q19.E[:_Q7]                   # rest + 6 axis directions
_OPP7 = D3Q19.OPP[:_Q7]               # closed under opposition
_W7 = np.array([0.25] + [0.125] * 6, np.float32)
_INV_CS2 = np.float32(4.0)            # 1 / c_s^2 for this weight set


def tau_g_of(D_lat: float) -> float:
    """Relaxation time for lattice diffusivity D: tau_g = 1/2 + 4 D."""
    return 0.5 + 4.0 * float(D_lat)


def phi7(u) -> jnp.ndarray:
    """(7, ...) linear ADE equilibrium factor w_i (1 + 4 e_i.u):
    g_eq = c[None] * phi7(u). Linear (not quadratic) in u is the
    standard ADE closure — the scalar carries no momentum, so only the
    first moment (the advective flux c u) must be exact."""
    e = jnp.asarray(_E7.astype(np.float32))
    eu = jnp.tensordot(e, jnp.asarray(u, jnp.float32), axes=([1], [0]),
                       precision=jax.lax.Precision.HIGHEST)
    w = jnp.asarray(_W7).reshape((_Q7,) + (1,) * (eu.ndim - 1))
    return w * (1.0 + _INV_CS2 * eu)


def _project(u, blocked_axes):
    """Impermeability projection (see ScalarTransport): zero each
    velocity component at cells with a wall neighbor along that axis."""
    return jnp.where(blocked_axes, 0.0, u)


def _defect(u_proj, nbr_block, bc_geo):
    """The scheme's EXACT one-pass concentration deviation at uniform
    c = 1 (stream with bounce-back + plane fixups, then sum) — the
    discrete divergence the div_fix compensation cancels. Verified to
    match the measured one-step deviation to 3e-7 (tests). bc_geo:
    list of (dir, axis, sign, slicer, plane_mask) per boundary."""
    d = jnp.zeros(u_proj.shape[1:], jnp.float32)
    terms = {}
    for i in range(1, _Q7):
        a = int(np.argmax(np.abs(_E7[i])))
        s = int(_E7[i][a])
        nb_u = jnp.roll(u_proj[a], shift=s, axis=a) * np.float32(s)
        terms[i] = jnp.where(nbr_block[i - 1], 0.0, 0.5 * nb_u)
        d = d + terms[i]
    for (di, a, s, sl, plane) in bc_geo:
        # the fixup expresses the crossing pull in the CONSUMER cell's
        # own u — swap that plane's term accordingly
        d = d.at[sl].add(jnp.where(
            plane, 0.5 * u_proj[a][sl] * np.float32(s) - terms[di][sl],
            0.0))
    return d


def bc_geometry(spec: CaseSpec):
    """Per-boundary D3Q7 plane geometry: (dir, axis, sign, consumer
    slicer, footprint mask). In D3Q7 exactly one direction crosses an
    axis plane, so each BC fixup touches one channel."""
    mask = np.asarray(spec.mask)
    geo = []
    for bc in spec.boundaries:
        dirs = [i for i in range(1, _Q7)
                if int(_E7[i][bc.axis]) * bc.normal > 0]
        assert len(dirs) == 1
        plane = np.take(mask, bc.coord, axis=bc.axis) == bc.mask_value
        geo.append((dirs[0], bc.axis, int(_E7[dirs[0]][bc.axis]),
                    _plane_slicer(bc.axis, bc.coord + bc.normal),
                    jnp.asarray(plane)))
    return geo


def dirichlet_walls(mask, wall_c):
    """Anti-bounce-back Dirichlet (fixed-value) scalar walls.

    wall_c: (X, Y, Z) float array — the prescribed boundary value c_w
    at Dirichlet wall cells, NaN where the wall stays adiabatic (plain
    bounce-back, the default zero-normal-flux wall). Every finite cell
    must be a blocking (WALL/MOVING) cell. Returns (nbr_dir, cw2): the
    per-direction masks "the donor cell x - e_i is a Dirichlet wall"
    and the pre-rolled constants 2 w_i c_w, so the stream pass replaces
    that link's bounce-back with the anti-bounce-back closure

        g_i(x, t+1) = 2 w_i c_w - g_opp(i)(x, t)

    which pins the half-way wall point to c_w: at the link midpoint the
    i/opp(i) pair sums to 2 w_i c_w, i.e. the pair's local concentration
    contribution equals its equilibrium at c = c_w (resting wall — the
    Dirichlet value rides static walls; a moving isothermal wall would
    add 4 e_i.u_w inside the bracket). This is the standard second-order
    Dirichlet condition for ADE-LBM, the scalar twin of the flow's
    half-way bounce-back. Used for isothermal walls by the Boussinesq
    thermal route (engine/thermal.py) and available to the frozen-field
    ScalarTransport (e.g. a perfectly absorbing wall: c_w = 0)."""
    wc = np.asarray(wall_c, np.float32)
    isd = np.isfinite(wc)
    # STATIC walls only: the anti-bounce-back closure below omits the
    # moving-wall velocity term (a moving isothermal wall needs
    # + 4 w_i (e_i . u_w) inside the bracket), so a Dirichlet value on
    # a MOVING cell would be silently first-order wrong — refuse loudly
    # (ADVICE r4).
    assert (np.asarray(mask)[isd] == CellType.WALL).all(), (
        "wall_c prescribes values at non-wall (or MOVING) cells; "
        "Dirichlet scalar values live on STATIC WALL cells only (NaN "
        "= adiabatic; a MOVING isothermal wall would need the e_i.u_w "
        "closure term, which is not implemented)")
    vals = np.where(isd, wc, 0.0).astype(np.float32)
    nbr_dir, cw2 = [], []
    for i in range(1, _Q7):
        sh = tuple(int(v) for v in _E7[i])
        ax = (0, 1, 2)
        nbr_dir.append(np.roll(isd, shift=sh, axis=ax))
        cw2.append(2.0 * _W7[i] * np.roll(vals, shift=sh, axis=ax))
    return (jnp.asarray(np.stack(nbr_dir)),
            jnp.asarray(np.stack(cw2).astype(np.float32)))


def _transport_pass(g, t, phi, nbr_block, bcs, omega, tau_g, div_comp,
                    source, fluid, dirichlet=None):
    """One ADE step given the equilibrium factor phi (static for the
    frozen-field ScalarTransport; rebuilt per step from the live macro
    by CoupledTransport). bcs: list of (dir, slicer, valid, c_fn).
    dirichlet: optional (nbr_dir, cw2) from dirichlet_walls — links into
    those walls use anti-bounce-back instead of bounce-back."""
    pulled = [g[0]]
    for i in range(1, _Q7):
        direct = pull_one(g[i], _E7[i])
        v = jnp.where(nbr_block[i - 1], g[int(_OPP7[i])], direct)
        if dirichlet is not None:
            nbr_dir, cw2 = dirichlet
            v = jnp.where(nbr_dir[i - 1],
                          cw2[i - 1] - g[int(_OPP7[i])], v)
        pulled.append(v)
    pulled = jnp.stack(pulled)
    for (d, sl, valid, c_fn) in bcs:
        ph = phi[(d,) + sl]
        g_pl = g[(slice(None),) + sl]              # (7, A, B)
        c_prev = jnp.sum(g_pl, axis=0)
        if c_fn is None:                           # zero-gradient
            c_star = c_prev
        elif callable(c_fn):
            c_star = c_fn(t)
        else:
            c_star = np.float32(c_fn)
        val = c_star * ph + (g_pl[d] - c_prev * ph) * omega
        pulled = pulled.at[(d,) + sl].set(
            jnp.where(valid, val, pulled[(d,) + sl]))
    c = jnp.sum(pulled, axis=0)
    # tau_g/omega may be TRACED scalars (the differentiable-D route,
    # engine/adjoint.fit_diffusivity) — jnp.asarray instead of a
    # np.float32 cast, which rejects tracers
    g_post = pulled - (pulled - c[None] * phi) / jnp.asarray(
        tau_g, jnp.float32)
    w = jnp.asarray(_W7).reshape((_Q7, 1, 1, 1))
    if div_comp is not None:
        g_post = g_post + (c * div_comp)[None] * w
    if source:
        g_post = g_post + np.float32(source) * w
    g_new = jnp.where(fluid[None], g_post, g)
    return g_new, c


class ScalarTransport:
    """Frozen-field advection-diffusion solver on one case's geometry.

    spec: the flow CaseSpec (mask + boundary planes are reused).
    u: (3, X, Y, Z) frozen lattice velocity — a converged
       Simulation.macro()[1] from any backend.
    D / tau_g: lattice diffusivity (one of the two; D wins).
    inlet_c: {boundary_index: c} prescribed concentrations, where c is
       a float or a callable(t)->scalar (traced; e.g. a bolus gate
       lambda t: jnp.where(t < 500, 1.0, 0.0)). Boundary planes NOT
       listed get the zero-gradient outflow fixup.
    source: uniform volumetric source s on fluid cells (mean-age mode:
       source=1.0, inlet_c={inlet: 0.0}).
    c0: initial concentration field (X, Y, Z) (default 0 everywhere).
    div_fix: compensate the frozen field's discrete divergence
       (default True). The ADE-LBM solves the CONSERVATIVE form
       dc/dt + div(u c) = D lap(c); the converged flow is mass-
       conserving in its own 19-direction streaming stencil but NOT in
       the scalar's central-difference sense (measured ~0.8% residual
       central div at staircase rim cells on the converged n=16 pipe),
       so uniform c is not a fixed point and a saturated wash-in
       overshoots c = 1. The fix adds the advective-form correction
       + c(x) * defect(x) with defect = the scheme's EXACT one-pass
       deviation at uniform c (built with the same rolls, bounce-back
       masks and BC-plane fixup expressions the step uses — verified
       to match the measured one-step deviation to 3e-7). One fused
       FMA per cell per step; measured on the saturated pipe wash-in:
       max |c - 1| 9.1% -> 3.4%, mean 1.8% -> 0.9% (the residual is
       second-order, localized at low-velocity wall corners, and
       shrinks with larger D — the artifact scales with cell Peclet).
    wall_c: optional (X, Y, Z) Dirichlet wall values — finite entries
       mark WALL/MOVING cells whose scalar value is pinned by
       anti-bounce-back (see dirichlet_walls); NaN cells stay the
       default adiabatic bounce-back wall. Note div_fix's defect
       derivation treats every wall link as bounce-back — exact only
       when the local c matches c_w there; the Boussinesq thermal route
       (engine/thermal.py) therefore defaults div_fix off.
    mesh / shard_axis: GSPMD decomposition over a jax.sharding.Mesh —
       g and every per-cell static shard along a BC-free lattice axis
       (free_axis default) and XLA's partitioner inserts the one-deep
       halo exchanges and record-plane psums (same mechanism as the
       flow runner's backend='xla' mesh=; CoupledTransport takes the
       same kwargs and additionally shards f).
    """

    def __init__(self, spec: CaseSpec, u, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 inlet_c: Optional[dict] = None, source: float = 0.0,
                 c0=None, div_fix: bool = True, wall_c=None, mesh=None,
                 shard_axis: Optional[int] = None):
        assert (D is None) != (tau_g is None), (
            "give exactly one of D (lattice diffusivity) or tau_g")
        self.tau_g = float(tau_g_of(D) if D is not None else tau_g)
        assert self.tau_g > 0.5, "tau_g must exceed 1/2 (D > 0)"
        self.spec = spec
        mask = np.asarray(spec.mask)
        blocking = (mask == CellType.WALL) | (mask == CellType.MOVING)
        self.fluid = jnp.asarray(mask == CellType.FLUID)
        nbr = [np.roll(blocking, shift=tuple(int(v) for v in _E7[i]),
                       axis=(0, 1, 2)) for i in range(1, _Q7)]
        self.nbr_block = jnp.asarray(np.stack(nbr))   # (6, X, Y, Z)
        u = np.array(u, np.float32)
        assert u.shape == (3,) + tuple(spec.shape), u.shape
        # Impermeability projection: zero the velocity component along
        # any blocked axis at wall-adjacent cells. Bounce-back of g is
        # the zero-flux wall ONLY where e_i.u = 0 for the blocked
        # direction; the frozen flow macro carries small O(Ma^2)
        # normal components at staircase walls, and leaving them in
        # shifts the wall-cell fixed point (one of the two error
        # sources the saturated wash-in measures; the other is the
        # discrete divergence handled by div_fix below). Tangential
        # transport at the wall is untouched.
        self.blocked_axes = jnp.asarray(np.stack(
            [nbr[2 * a] | nbr[2 * a + 1] for a in range(3)]))
        u = np.asarray(_project(jnp.asarray(u), self.blocked_axes))
        self.phi = phi7(jnp.asarray(u))               # (7, X, Y, Z)
        self.omega = np.float32(1.0 - 1.0 / self.tau_g)

        inlet_c = dict(inlet_c or {})
        self._bcs = []        # (dir_i, slicer, valid(A,B), c_star|None)
        self._bc_geo = bc_geometry(spec)
        for k, bc in enumerate(spec.boundaries):
            d, _, _, sl, plane = self._bc_geo[k]
            self._bcs.append((d, sl, plane, inlet_c.pop(k, None)))
        assert not inlet_c, f"inlet_c names absent boundaries: {inlet_c}"
        self.div_comp = None
        if div_fix:
            defect = _defect(jnp.asarray(u), self.nbr_block,
                             self._bc_geo)
            self.div_comp = jnp.where(self.fluid, -defect, 0.0)
        self.source = float(source)
        self.dirichlet = (None if wall_c is None
                          else dirichlet_walls(mask, wall_c))
        if wall_c is not None and div_fix:
            # the defect derivation treats every wall link as
            # bounce-back; near Dirichlet walls the compensation is
            # exact only where the local c matches c_w (ADVICE r4:
            # no silent slightly-wrong composition)
            print("[lbm_jax] ScalarTransport: div_fix=True with "
                  "wall_c — the divergence compensation assumes pure "
                  "bounce-back walls and is approximate near Dirichlet "
                  "cells; pass div_fix=False to silence (the thermal "
                  "route's default)", flush=True)
        if c0 is None:
            self.g = jnp.zeros((_Q7,) + tuple(spec.shape), jnp.float32)
        else:
            c0 = jnp.asarray(c0, jnp.float32)
            self.g = jnp.where(self.fluid[None], c0[None] * self.phi, 0.0)
        self.t = 0
        self._scan_cache = {}   # (n_steps, record tuple) -> jitted scan
        if mesh is not None:
            self._shard(mesh, shard_axis)

    def _shard(self, mesh, shard_axis: Optional[int]):
        """GSPMD decomposition over a device mesh: shard the g state
        and every per-cell static along a BC-free lattice axis and let
        XLA's SPMD partitioner turn the step's rolls into one-deep halo
        CollectivePermutes and the record-plane sums into psums — the
        exact mechanism of the flow runner's backend='xla' mesh= path
        (engine/runner.py). The BC plane fixups slice along a NON-shard
        axis (free_axis guarantees it), so they stay shard-local."""
        from lbm_jax.parallel.mesh import free_axis, lattice_sharding

        axis = free_axis(self.spec) if shard_axis is None else shard_axis
        put = lambda x, lead: (None if x is None else jax.device_put(  # noqa: E731
            x, lattice_sharding(axis=axis, mesh=mesh, leading=lead)))
        self.g = put(self.g, 1)
        self.phi = put(self.phi, 1)
        self.nbr_block = put(self.nbr_block, 1)
        self.div_comp = put(self.div_comp, 0)
        self.fluid = put(self.fluid, 0)
        if self.dirichlet is not None:
            self.dirichlet = tuple(put(a, 1) for a in self.dirichlet)

    @property
    def fields(self):
        """The big per-cell static fields, threaded through run()'s jit
        as ARGUMENTS — closed-over device arrays lower to HLO constants,
        and at the flagship coronary box the (7, 291, 291, 372) phi
        alone would be 882 MB of literal in the program. div_comp is None when div_fix=False (a
        pytree hole, static to the trace); dirichlet likewise when no
        wall_c is set."""
        return (self.phi, self.nbr_block, self.div_comp, self.fluid,
                self.dirichlet)

    def make_step(self) -> Callable:
        """(g, t, fields) -> (g', c') — pull-stream with fused wall
        bounce-back + plane fixups, then the precomputed-equilibrium
        collide. `fields` is self.fields (see there for why it is an
        argument)."""

        def step(g, t, fields):
            phi, nbr_block, div_comp, fluid, dirichlet = fields
            return _transport_pass(g, t, phi, nbr_block,
                                   self._bcs, self.omega, self.tau_g,
                                   div_comp, self.source, fluid,
                                   dirichlet)

        return step

    def run(self, n_steps: int, record: Optional[list] = None):
        """Advance n_steps (one jitted lax.scan). record: boundary
        indices whose consumer-plane mean concentration is sampled
        EVERY step — returns the (n_steps, len(record)) series (the
        washout/bolus curves), else None."""
        key = (int(n_steps), None if record is None else tuple(record))
        if key not in self._scan_cache:
            rec = [] if record is None else [
                (self._bcs[k][1], self._bcs[k][2]) for k in record]
            denom = [jnp.float32(jnp.sum(v)) for _, v in rec]
            step = self.make_step()

            def scan_fn(g, t0, fields):
                def body(carry, t):
                    g, = carry
                    g, c = step(g, t, fields)
                    ys = (jnp.stack(
                        [jnp.sum(jnp.where(v, c[sl], 0.0)) / dn
                         for (sl, v), dn in zip(rec, denom)])
                        if rec else jnp.zeros((0,), jnp.float32))
                    return (g,), ys

                return jax.lax.scan(
                    body, (g,),
                    t0 + jnp.arange(n_steps, dtype=jnp.int32))

            self._scan_cache[key] = jax.jit(scan_fn)
        (self.g,), series = self._scan_cache[key](
            self.g, jnp.int32(self.t), self.fields)
        self.t += n_steps
        return np.asarray(series) if record is not None else None

    def concentration(self) -> jnp.ndarray:
        """(X, Y, Z) scalar field (zeros at non-fluid cells)."""
        return jnp.where(self.fluid, jnp.sum(self.g, axis=0), 0.0)

    def total(self) -> float:
        """Total scalar content (conservation audit). Summed in f64 on
        host — the audit must not be noisier than the drift it checks
        (fp32 reduction noise over ~1e5 cells is ~1e-5 relative, while
        the scheme's true per-step drift is pure rounding, measured to
        wander near +/-1e-4 relative over hundreds of steps with no
        systematic leak)."""
        return float(np.asarray(self.g, np.float64).sum())


class CoupledTransport:
    """Time-resolved transport: the flow and the scalar advance in the
    SAME lax.scan, the scalar advecting in each step's live macro u —
    the pulsatile regime (series inlets, windkessel outlets) where a
    frozen field is wrong. Still one-way coupled physically (the tracer
    does not feed back into the flow), but numerically simultaneous:
    per step the flow's fused pass runs first, then the ADE pass
    rebuilds phi7 / the div_fix defect from that step's (projected)
    macro — ~6 extra rolls + one (7,3) tensordot per step on top of
    the 19-channel flow step (dense-XLA backend; the transport rides
    whatever the flow case supports, incl. windkessel state).

    On a CONVERGED steady flow this reproduces the frozen-field
    ScalarTransport exactly (tested to fp32), so the frozen class
    remains the cheap steady-state route.

    f0/wk0: optional flow state to start from (e.g. a converged
    Simulation's sim.f / sim.wk); defaults to the case's initial f.
    """

    def __init__(self, spec: CaseSpec, D: Optional[float] = None,
                 tau_g: Optional[float] = None,
                 inlet_c: Optional[dict] = None, source: float = 0.0,
                 c0=None, div_fix: bool = True, wall_c=None, f0=None,
                 wk0=None, mesh=None,
                 shard_axis: Optional[int] = None):
        from lbm_jax.engine.compile import compile_case, wk_init
        from lbm_jax.engine.step import (has_windkessel, initial_f,
                                         make_step, make_step_wk)

        assert (D is None) != (tau_g is None), (
            "give exactly one of D (lattice diffusivity) or tau_g")
        self.tau_g = float(tau_g_of(D) if D is not None else tau_g)
        assert self.tau_g > 0.5, "tau_g must exceed 1/2 (D > 0)"
        self.spec = spec
        self.cc = compile_case(spec)
        self.has_wk = has_windkessel(self.cc.bcs)
        self._make_flow_step = make_step_wk if self.has_wk else make_step
        mask = np.asarray(spec.mask)
        blocking = (mask == CellType.WALL) | (mask == CellType.MOVING)
        self.fluid = jnp.asarray(mask == CellType.FLUID)
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

        self.f = initial_f(self.cc) if f0 is None else jnp.asarray(f0)
        w0 = wk_init(self.cc.bcs)
        self.wk = (None if not self.has_wk else
                   jnp.asarray(w0 if wk0 is None else wk0, jnp.float32))
        if c0 is None:
            self.g = jnp.zeros((_Q7,) + tuple(spec.shape), jnp.float32)
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
        """GSPMD decomposition of BOTH states: the 19-channel flow f
        rides the flow engine's own mesh= mechanism (shard f and the
        compiled case — exactly engine/runner.py backend='xla' mesh=),
        the 7-channel g and the per-cell scalar statics shard like
        ScalarTransport._shard."""
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
        # wk is (n_wk, ...) scalars — replicated, left alone

    @property
    def fields(self):
        """Big per-cell statics as jit ARGUMENTS (same HLO-constant
        argument as ScalarTransport.fields), the flow's compiled case
        (a pytree) included."""
        return (self.nbr_block, self.blocked_axes, self.fluid,
                self.dirichlet, self.cc)

    def _coupled_step(self, f, t, wk, g, fields):
        nbr_block, blocked_axes, fluid, dirichlet, cc = fields
        flow_step = self._make_flow_step(cc)
        if self.has_wk:
            f_new, _, u, wk_new = flow_step(f, t, wk)
        else:
            f_new, _, u = flow_step(f, t)
            wk_new = wk
        u_proj = _project(u, blocked_axes)
        phi = phi7(u_proj)
        comp = None
        if self.div_fix:
            comp = jnp.where(
                fluid,
                -_defect(u_proj, nbr_block, self._bc_geo), 0.0)
        g_new, c = _transport_pass(g, t, phi, nbr_block, self._bcs,
                                   self.omega, self.tau_g, comp,
                                   self.source, fluid, dirichlet)
        return f_new, wk_new, g_new, c

    def run(self, n_steps: int, record: Optional[list] = None):
        """Advance flow + scalar n_steps in one scan; record as in
        ScalarTransport.run (per-step consumer-plane mean c series)."""
        key = (int(n_steps), None if record is None else tuple(record))
        if key not in self._scan_cache:
            rec = [] if record is None else [
                (self._bc_geo[k][3], self._bc_geo[k][4]) for k in record]
            denom = [jnp.float32(jnp.sum(v)) for _, v in rec]

            def scan_fn(f, wk, g, t0, fields):
                def body(carry, t):
                    f, wk, g = carry
                    f, wk, g, c = self._coupled_step(f, t, wk, g,
                                                     fields)
                    ys = (jnp.stack(
                        [jnp.sum(jnp.where(v, c[sl], 0.0)) / dn
                         for (sl, v), dn in zip(rec, denom)])
                        if rec else jnp.zeros((0,), jnp.float32))
                    return (f, wk, g), ys

                return jax.lax.scan(
                    body, (f, wk, g),
                    t0 + jnp.arange(n_steps, dtype=jnp.int32))

            self._scan_cache[key] = jax.jit(scan_fn)
        (self.f, self.wk, self.g), series = self._scan_cache[key](
            self.f, self.wk, self.g, jnp.int32(self.t), self.fields)
        self.t += n_steps
        return np.asarray(series) if record is not None else None

    concentration = ScalarTransport.concentration
    total = ScalarTransport.total


__all__ = ["ScalarTransport", "CoupledTransport", "phi7", "tau_g_of",
           "bc_geometry", "dirichlet_walls"]
