"""Declarative case specification.

Where the reference hard-codes every parameter as compile-time constants
in four separate .cu programs (SURVEY.md section 5, "Config / flag
system: none"), this framework has one engine driven by a CaseSpec: grid,
tau, units, the labeled mask, a table of plane boundary conditions, init
fields, and run/convergence policy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lbm_jax.core.units import UnitSystem


@dataclasses.dataclass
class PlaneBC:
    """A non-equilibrium-extrapolation (NEE) boundary on an axis plane.

    Generalizes all five reference variants (SURVEY.md section 0):
      lid (ldc.cu:373-458):        rho extrapolated, u fixed vector
      velocity inlet/outlet (Poiseulle.cu:748-891): rho extrapolated,
                                   u from a lateral field (the parabola)
      measured-map inlet (bifurcation.cu:950-1021): rho extrapolated,
                                   u from a lateral field (bc.txt)
      pressure outlet (bifurcation.cu:877-948): rho fixed (=1),
                                   u extrapolated from the fluid neighbor
      velocity+pressure inlet (coronary.cu:716-792): rho fixed AND u fixed

    For direction i with e_i . n > 0 (n = inward normal) and fluid
    neighbor F = b + e_i:
        f_i(b) = feq_i(rho*, u*) + (f_i(F) - feq_i(rho_F, u_F)) (1 - 1/tau)
    """

    mask_value: int          # cell label this BC applies to (2, 3, 5, ...)
    axis: int                # 0=x, 1=y, 2=z
    coord: int               # plane index along `axis`
    normal: int              # +1/-1: inward normal direction (into fluid)
    rho_mode: str = "extrapolate"    # 'extrapolate' | 'fixed'
    rho_value: float = 1.0
    u_mode: str = "fixed"            # 'fixed' | 'field' | 'extrapolate' | 'series'
    u_value: tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_field: Optional[np.ndarray] = None    # (3, A, B) lateral field
    u_series: Optional[np.ndarray] = None   # (T, 3, A, B) per-step fields
    u_series_stride: int = 1                # steps per series phase
    #   (phase = (t // stride) % T; the thesis streams unsteady BC arrays
    #   per step, section 4.5-E — stride lets long pulses stay compact)
    # 3-element Windkessel (RCR) outlet coupling (beyond-reference: the
    # reference's outlets are constant-pressure, bifurcation.cu:877-948,
    # while clinical hemodynamics terminates vessels on lumped RCR
    # models). (Rp, C, Rd) in LATTICE units (UnitSystem
    # .to_lattice_resistance/.to_lattice_compliance convert from SI):
    # the plane's gauge pressure becomes P_in = Q Rp + P_c with
    # C dP_c/dt = Q - P_c/Rd, Q = outward flux through the plane —
    # so rho* = rho_value + 3 P_in varies per step. Requires
    # rho_mode='fixed' (a pressure outlet whose pressure is dynamic).
    # The (one-float-per-outlet) state P_c is carried by the step
    # (engine/step.make_step_wk); supported on the dense XLA backend
    # (incl. GSPMD mesh sharding) and the sparse backend.
    windkessel: Optional[tuple[float, float, float]] = None
    windkessel_p0: float = 0.0              # initial P_c (lattice gauge)

    def __post_init__(self):
        assert self.axis in (0, 1, 2) and self.normal in (-1, 1)
        assert self.rho_mode in ("extrapolate", "fixed")
        assert self.u_mode in ("fixed", "field", "extrapolate", "series")
        if self.u_mode == "field":
            assert self.u_field is not None and self.u_field.ndim == 3
        if self.u_mode == "series":
            assert self.u_series is not None and self.u_series.ndim == 4
        if self.windkessel is not None:
            self.windkessel = tuple(float(v) for v in self.windkessel)
            rp, cap, rd = self.windkessel
            assert rp >= 0.0 and cap > 0.0 and rd > 0.0, \
                "windkessel needs Rp >= 0, C > 0, Rd > 0"
            assert self.rho_mode == "fixed", \
                "windkessel couples to a pressure outlet (rho_mode='fixed')"


# eq=False: a spec compares and hashes by identity, so a compiled case
# can carry it as static pytree data (engine/compile.register_case).
@dataclasses.dataclass(eq=False)
class CaseSpec:
    name: str
    shape: tuple[int, int, int]
    tau: float
    units: UnitSystem
    mask: np.ndarray                     # (nx, ny, nz) int labels
    boundaries: list[PlaneBC]
    rho0: Optional[np.ndarray] = None    # (nx, ny, nz); default 1
    u0: Optional[np.ndarray] = None      # (3, nx, ny, nz); default 0
    # Run policy (reference values: ldc.cu:614-615, bifurcation.cu:19).
    max_steps: int = 10000
    time_save: int = 500
    tol: float = 1e-6
    stag_max: int = 50
    # Collision operator. 'bgk' is the reference's SRT (ldc.cu:350-368).
    # 'trt' (two-relaxation-time, beyond-reference: the MRT/TRT scheme of
    # the reference's Lectures/ notes, never implemented in its code) adds
    # a second rate for the odd-parity moments, derived from the "magic"
    # parameter:  Lambda = (tau - 1/2)(tau_minus - 1/2), so
    # tau_minus = 1/2 + Lambda / (tau - 1/2). Lambda = 3/16 places the
    # half-way bounce-back wall EXACTLY at the mid-plane for parallel
    # flows independent of viscosity (Ginzburg/d'Humieres); with
    # Lambda = (tau - 1/2)^2 TRT degenerates to BGK.
    collision: str = "bgk"               # 'bgk' | 'trt' | 'mrt'
    magic_lambda: float = 0.1875         # TRT magic parameter (3/16)
    # MRT rate overrides by class ('e', 'eps', 'q', 'pi', 'm'); shear
    # rows always relax at 1/tau (viscosity), conserved rows at 0. See
    # core/mrt.py for the basis, defaults, and the BGK/TRT degeneracy
    # anchors.
    mrt_rates: Optional[dict] = None
    # Smagorinsky LES closure (beyond-reference; the reference is
    # laminar-only): per-cell effective relaxation
    # tau_eff = (tau + sqrt(tau^2 + 18 Cs^2 P / rho))/2 with
    # P = sqrt(2 Pi:Pi), Pi_ab = sum_i e_ia e_ib f_neq_i — the standard
    # closed-form eddy viscosity nu_t = (Cs D)^2 |S| (Hou et al.),
    # D = 1 lattice cell. Typical Cs ~ 0.1-0.2. Requires
    # collision='bgk'. Composes with `force` on the matmul backends
    # (per-cell variable-rate Guo prefactor 1 - 1/(2 tau_eff)).
    # None => no LES (bit-identical code path).
    smagorinsky_cs: Optional[float] = None
    # Shear-rate-dependent (non-Newtonian) rheology closure
    # (core/rheology.py; beyond-reference — the reference is Newtonian,
    # while blood is shear-thinning). A dict, e.g.
    #   {'model': 'power_law', 'K': 0.05, 'n': 0.7}
    #   {'model': 'carreau', 'nu0': 0.1, 'nu_inf': 0.01,
    #    'lam': 100.0, 'n': 0.4, 'a': 2.0}
    #   {'model': 'casson', 'nu_c': 0.02, 'tau_y': 1e-5}  (closed form)
    # optional keys: 'tau_bounds' (default (0.5005, 20.0)) clipping the
    # per-cell tau_eff, 'iters' (default 8) Picard iterations of the
    # implicit tau_eff = 1/2 + 3 nu(gamma(tau_eff)) fixed point. All in
    # lattice units. Exclusive with smagorinsky_cs; same constraints
    # (collision='bgk'; force only on the matmul backends).
    rheology: Optional[dict] = None
    # Constant body force density (lattice units, momentum added per
    # cell per step), applied with Guo's exact scheme (beyond-reference:
    # README.md:2 states body force/gravity is NOT considered there):
    # u = (sum e_i f_i + F/2)/rho, and a source term carrying
    # (1 - rate/2) of each moment's own relaxation rate — parity-split
    # for BGK/TRT, the moment-space matrix KF for MRT — so it composes
    # exactly with every collision operator. None => no forcing (the
    # force-free code path is bit-identical to before).
    force: Optional[tuple[float, float, float]] = None
    # Signed distance field at cell centers (positive in fluid), same
    # shape as the mask: opts every FLUID->WALL link into Bouzidi linear
    # interpolated bounce-back (core/bouzidi.py) — second-order curved
    # walls instead of the voxel staircase (beyond-reference: the
    # reference accepts the staircase on all its vessel geometries).
    # Supported on the dense XLA backend (incl. GSPMD mesh sharding)
    # and the sparse backend; backend='auto' falls back to xla. Static
    # walls only (exclusive with wall_velocity/MOVING cells).
    wall_sdf: Optional[np.ndarray] = None
    # Velocity (lattice units) of MOVING-labeled wall cells
    # (CellType.MOVING), realized as half-way bounce-back with the Ladd
    # momentum term: pulled_i = f_opp + 6 w_i rho0 (e_i . u_w) with
    # rho0 = 1 (beyond-reference: the README excludes moving boundaries;
    # "moving boundary ... NOT considered", /root/reference/README.md:2).
    # Required iff the mask contains MOVING cells.
    wall_velocity: Optional[tuple[float, float, float]] = None
    residual_flavor: str = "velsum"      # 'velsum' (per-step sum|u|,
    #                                       ldc.cu:460-466,668) |
    #                                      'usq' (windowed sum u^2,
    #                                       bifurcation.cu:1158-1175)
    usq_includes_outlet_labels: bool = True  # bifurcation sums geo>=4
    #                                      (bifurcation.cu:1167); coronary
    #                                      sums geo==4 only (coronary.cu:1022)
    vtk_crops: tuple[int, int, int] = (2, 2, 2)  # per-axis interior crop
    #                                      (ldc.cu:592: 2 everywhere;
    #                                       vessel cases: (1, 2, 1),
    #                                       bifurcation.cu:1103)
    vtk_density: bool = False            # also write DENSITY/PRESSURE
    #                                      scalars (coronary.cu:961-988)
    vtk_origin_offset: int = 0           # ORIGIN = round(n/2 + off)*CH:
    #                                      0 for poiseuille/bifurcation/
    #                                      coronary (coronary.cu:958);
    #                                      -1 for lid (ldc.cu:594 writes
    #                                      round(NX/2-1)*CH)

    def __post_init__(self):
        assert self.mask.shape == tuple(self.shape)
        assert self.collision in ("bgk", "trt", "mrt")
        if self.collision == "trt":
            assert self.tau > 0.5, "TRT needs tau > 1/2"
            assert self.magic_lambda > 0.0
        if self.collision == "mrt":
            assert self.tau > 0.5, "MRT needs tau > 1/2"
        if self.smagorinsky_cs is not None:
            self.smagorinsky_cs = float(self.smagorinsky_cs)
        if self.smagorinsky_cs is not None or self.rheology is not None:
            from lbm_jax.core.rheology import normalize_closure
            # validates params and the exclusivity of the two knobs
            normalize_closure(self.smagorinsky_cs, self.rheology)
            assert self.collision in ("bgk", "trt"), (
                "per-cell tau closures compose with BGK (tau_eff) and "
                "TRT (even at tau_eff, odd via the constant magic "
                "Lambda — engine/step.closure_tau_minus); MRT's "
                "moment-space rates are not wired")
        if self.force is not None:
            self.force = tuple(float(c) for c in self.force)
            assert len(self.force) == 3
        from lbm_jax.geometry.mask import CellType as _CT
        has_moving = bool((self.mask == int(_CT.MOVING)).any())
        if self.wall_sdf is not None:
            self.wall_sdf = np.asarray(self.wall_sdf, np.float32)
            assert self.wall_sdf.shape == tuple(self.shape), \
                "wall_sdf must match the lattice shape"
            assert not has_moving, \
                "wall_sdf (Bouzidi curved walls) supports static walls only"
        if self.wall_velocity is not None:
            self.wall_velocity = tuple(float(c) for c in self.wall_velocity)
            assert len(self.wall_velocity) == 3
            assert has_moving, "wall_velocity set but no MOVING cells"
        else:
            assert not has_moving, "MOVING cells need wall_velocity"
        if self.rho0 is None:
            self.rho0 = np.ones(self.shape, np.float32)
        if self.u0 is None:
            self.u0 = np.zeros((3,) + tuple(self.shape), np.float32)


__all__ = ["PlaneBC", "CaseSpec"]
