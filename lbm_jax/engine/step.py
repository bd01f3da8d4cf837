"""The fused D3Q19 time step: pull-stream + bounce-back + NEE + BGK collide
in one pass over the lattice.

This is a single-pass re-design of the reference's two-kernel hot loop
(`update` + `boundary_stream`, e.g. Poiseulle.cu:384-893). The reference's
boundary writes are all consumed exactly by the cell that donated the
data (see compile.py), so both kernels fuse into one local pass:

  for fluid cell x, direction i, neighbor n = x - e_i:
    pulled_i(x) = f[i][n]                      if n is bulk/ghost/dead
                = f[opp(i)][x]                 if n is wall (half-way BB)
                = feq_i(rho*, u*) +
                  (f[i][x] - feq_i(rho_prev[x], u_prev[x])) (1 - 1/tau)
                                               if n is an NEE boundary
  rho, u = moments(pulled); f'(x) = pulled - (pulled - feq(rho, u))/tau

Because BGK conserves rho and u, the "previous-step macroscopics" the NEE
formula needs are just moments of the carried f on the one-cell consumer
plane — no macroscopic fields are carried between steps. Non-fluid cells
never change, matching the reference where ghost/dead cells keep their
init feq and boundary-cell macro arrays keep their init values.

Transient-ordering note: ldc.cu:75-202 applies wall bounce-back on the
PRE-collision array inside `update` (with an intra-kernel race the later
solvers fixed); this engine uses the post-collision ordering of
Poiseulle.cu:601-746 / bifurcation.cu:654-799 for every case. Steady
states are identical; ldc transients differ slightly from the (racy)
original.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19, phi
from lbm_jax.engine.compile import CompiledBC, CompiledCase

_E = D3Q19.E
_OPP = D3Q19.OPP


def pull_one(fi, e) -> jnp.ndarray:
    """Pull-stream one direction: value at x - e arrives at x."""
    shifts = [int(s) for s in e]
    axes = [a for a, s in enumerate(shifts) if s != 0]
    if not axes:
        return fi
    return jnp.roll(fi, shift=[shifts[a] for a in axes], axis=axes)


def _plane_slicer(axis: int, coord: int):
    idx = [slice(None)] * 3
    idx[axis] = coord
    return tuple(idx)


def _safe_u(f_plane, force=None):
    """moments on a (19, A, B) plane slice with guarded division."""
    rho = jnp.sum(f_plane, axis=0)
    mom = jnp.tensordot(
        jnp.asarray(_E.T.astype(f_plane.dtype)), f_plane, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )
    mom = half_force_shift(mom, force)
    return rho, mom / jnp.where(rho == 0, 1.0, rho)


def windkessel_update(p_c, q, wk):
    """One backward-Euler step (dt = 1 lattice step) of the 3-element
    windkessel (RCR) ODE:  C dP_c/dt = Q - P_c/Rd,  P_in = Q Rp + P_c.
    Returns (P_c', P_in) in lattice gauge-pressure units. Backward Euler
    is unconditionally stable, so stiff (small Rd·C) terminations can't
    blow up the coupling; the O(dt/(Rd C)) bias is tested against the
    analytic exponential in tests/test_windkessel.py.

    wk: the (Rp, C, Rd) triple — a static Python tuple (the normal
    route, constants folded at trace time) OR a traced (3,) array (the
    differentiable-parameter route, engine/adjoint.py: gradients flow
    through the RCR values so jax.grad can calibrate outlet
    terminations)."""
    if isinstance(wk, (tuple, list)):
        rp, cap, rd = (np.float32(v) for v in wk)
    else:
        rp, cap, rd = wk[0], wk[1], wk[2]
    p_new = (p_c + q / cap) / (np.float32(1.0)
                               + np.float32(1.0) / (rd * cap))
    return p_new, q * rp + p_new


def apply_bc_fixup(f_pulled, f_src, bc: CompiledBC, t, force=None,
                   wk_p=None, wk_rcr=None):
    """Overwrite the pulled populations on the consumer plane of one NEE
    boundary (exact fusion of the reference's boundary_stream NEE write,
    e.g. bifurcation.cu:877-1021). `force`: the case's Guo body force —
    the neighbor's previous-step macro u keeps the same half-force
    shift the collide uses.

    wk_p: carried windkessel state P_c for a windkessel-coupled outlet
    (bc.windkessel set) — the plane's rho* becomes
    rho_fixed + 3 (Q Rp + P_c') with Q the outward flux measured from
    the same previous-step consumer-plane macro the NEE formula reads;
    the call then returns (f_pulled, P_c').

    wk_rcr: optional traced (3,) (Rp, C, Rd) overriding bc.windkessel's
    static values — the differentiable-parameter route
    (engine/adjoint.py); bc.windkessel stays the coupling flag."""
    sl = _plane_slicer(bc.axis, bc.consumer_coord)
    src_pl = f_src[(slice(None),) + sl]            # (19, A, B)
    rho_prev, u_prev = _safe_u(src_pl, force)
    phi_nbr = phi(u_prev, dirs=bc.dirs)            # (D, A, B)
    feq_nbr = rho_prev[None] * phi_nbr

    if bc.u_mode in ("fixed", "field"):
        phi_star = bc.phi_star
    elif bc.u_mode == "series":
        T = bc.phi_star_series.shape[0]
        phase = (t // bc.series_stride) % T
        phi_star = jax.lax.dynamic_index_in_dim(
            bc.phi_star_series, phase, axis=0, keepdims=False
        )
    else:  # 'extrapolate': u* = u_F, so phi* == phi_nbr
        phi_star = phi_nbr

    p_new = None
    if bc.windkessel is not None:
        assert wk_p is not None, (
            "windkessel-coupled BC needs its carried P_c state (use "
            "make_step_wk / pulled_state_wk)"
        )
        # mask, don't multiply: 0-weight * NaN (a blown-up cell off the
        # outlet footprint) must not poison the flux sum
        q = np.float32(bc.flow_sign) * jnp.sum(
            jnp.where(bc.flow_weight != 0,
                      bc.flow_weight * u_prev[bc.axis], 0.0))
        p_new, p_in = windkessel_update(
            wk_p, q, bc.windkessel if wk_rcr is None else wk_rcr)
        rho_star = np.float32(bc.rho_fixed) + np.float32(3.0) * p_in
    elif bc.rho_fixed is not None:
        rho_star = bc.rho_fixed
    else:
        rho_star = rho_prev[None]
    src_dirs = src_pl[jnp.asarray(bc.dirs)]        # (D, A, B)
    val = rho_star * phi_star + (src_dirs - feq_nbr) * bc.omega

    for d, i in enumerate(bc.dirs):
        plane = f_pulled[(i,) + sl]
        f_pulled = f_pulled.at[(i,) + sl].set(
            jnp.where(bc.valid[d], val[d], plane)
        )
    return f_pulled if wk_p is None else (f_pulled, p_new)


def _is_force_field(force) -> bool:
    """True when `force` is a per-cell (3, ...) array (possibly traced)
    rather than the constant 3-vector CaseSpec.force carries — the
    Boussinesq buoyancy route (engine/thermal.py) feeds the flow a
    force field rebuilt each step from the live scalar."""
    return hasattr(force, "ndim") and force.ndim > 1


def half_force_shift(mom, force):
    """Guo velocity definition: u = (sum e_i f_i + F/2) / rho — returns
    the momentum with the half-step force added (no-op when force is
    None). Every moment consumer (collide, NEE previous-macro, macro
    outputs, velsum) uses this same shifted u. `force`: constant
    3-vector or a per-cell (3, ...) field (see _is_force_field)."""
    if force is None:
        return mom
    if _is_force_field(force):
        return mom + 0.5 * force
    fv = jnp.asarray(np.asarray(force, np.float32))
    return mom + 0.5 * fv.reshape((3,) + (1,) * (mom.ndim - 1))


def guo_source(u, force, tau, tau_minus=None, mrt_kf=None,
               tau_local=None, tau_local_minus=None):
    """(19, ...) Guo forcing source term with parity-split prefactors.

    Raw source G_i = w_i [3 (e_i - u) + 9 (e_i . u) e_i] . F splits into
    even parity G+ = w_i (9 (e_i.u)(e_i.F) - 3 u.F) and odd parity
    G- = 3 w_i e_i.F; each moment's source carries (1 - rate/2) of its
    OWN relaxation rate (the moment-space form of Guo's scheme), so
    BGK uses (1 - 1/(2 tau)) on both and TRT applies its odd rate to
    the odd half — which is what keeps the magic-Lambda wall placement
    exact for force-driven channel flow.

    tau_local: a per-cell tau_eff array (LES / non-Newtonian closures,
    core/rheology.py) — the variable-rate form of the same prefactor,
    (1 - 1/(2 tau_eff)) on both halves (the closure collide is BGK at
    tau_eff). tau_local_minus: per-cell ODD rate for the TRT+closure
    composition (closure_tau_minus) — the odd half takes its own
    (1 - 1/(2 tau_eff-)) prefactor."""
    e = jnp.asarray(_E.astype(np.float32))
    w = jnp.asarray(D3Q19.W.astype(np.float32))
    lead = (D3Q19.Q,) + (1,) * (u.ndim - 1)
    w_ = w.reshape(lead)
    if _is_force_field(force):
        # per-cell (3, ...) force field (engine/thermal.py buoyancy):
        # the same parity split, with eF/uF per cell
        eF = jnp.tensordot(e, force, axes=([1], [0]),
                           precision=jax.lax.Precision.HIGHEST)
        uF = (u[0] * force[0] + u[1] * force[1]
              + u[2] * force[2])[None]
    else:
        fv = np.asarray(force, np.float32)
        eF = jnp.asarray(_E.astype(np.float32) @ fv).reshape(lead)
        uF = (u[0] * fv[0] + u[1] * fv[1] + u[2] * fv[2])[None]
    eu = jnp.tensordot(e, u, axes=([1], [0]),
                       precision=jax.lax.Precision.HIGHEST)
    g_even = w_ * (np.float32(9.0) * eu * eF - np.float32(3.0) * uF)
    g_odd = np.float32(3.0) * w_ * eF
    if mrt_kf is not None:
        # moment-space prefactor: S = M^T diag((1 - s/2)/d) M G
        return jnp.tensordot(
            jnp.asarray(mrt_kf, jnp.float32), g_even + g_odd,
            axes=([1], [0]), precision=jax.lax.Precision.HIGHEST,
        )
    if tau_local is not None:
        cp_loc = np.float32(1.0) - np.float32(0.5) / tau_local
        if tau_local_minus is not None:
            cm_loc = np.float32(1.0) - np.float32(0.5) / tau_local_minus
            return cp_loc[None] * g_even + cm_loc[None] * g_odd
        return cp_loc[None] * (g_even + g_odd)
    cp = np.float32(1.0 - 0.5 / tau)
    cm = cp if tau_minus is None else np.float32(1.0 - 0.5 / tau_minus)
    return cp * g_even + cm * g_odd


def les_tau_eff(fneq, rho, tau, cs):
    """Back-compat wrapper: Smagorinsky is closure ('smag', cs) of the
    generalized per-cell machinery in core/rheology.py."""
    from lbm_jax.core.rheology import tau_eff
    return tau_eff(fneq, rho, tau, ("smag", float(cs)))


def closure_tau_minus(te, tau, tau_minus):
    """Per-cell ODD rate for a TRT + tau-closure composition: hold the
    magic parameter Lambda = (tau+ - 1/2)(tau- - 1/2) at its STATIC
    value while the closure varies the even rate — the standard
    stabilized LES/rheology-TRT pairing (wall placement and the
    bounce-back error are Lambda-controlled, so keeping Lambda fixed
    preserves them under the eddy/apparent viscosity)."""
    lam = np.float32((float(tau) - 0.5) * (float(tau_minus) - 0.5))
    return np.float32(0.5) + lam / (te - np.float32(0.5))


def collide(pulled, f_eq, tau, tau_minus=None, mrt_k=None,
            closure=None, rho=None):
    """Post-collision update. BGK (tau_minus=None): relax everything at
    1/tau, dividing like the reference (see make_step's precision note).
    TRT: split each population into even/odd parity halves about its
    bounce-back partner and relax them at 1/tau and 1/tau_minus —
    f' = f - [(f + f_o) - (feq + feq_o)]/(2 tau)
           - [(f - f_o) - (feq - feq_o)]/(2 tau_minus).
    The rest population (its own partner) reduces exactly to BGK.
    MRT (mrt_k = the (19,19) matrix from core/mrt.mrt_matrices):
    f' = f - K (f - feq) — one tensordot, so the moment-space
    relaxation runs as a matmul.
    Closure (a core/rheology tuple — LES or non-Newtonian, needs rho):
    BGK at the per-cell tau_eff; with tau_minus also set, the even
    parity relaxes at tau_eff and the odd at closure_tau_minus
    (constant magic Lambda)."""
    if closure is not None:
        fneq = pulled - f_eq
        if rho is None:
            rho = jnp.sum(pulled, axis=0)
        from lbm_jax.core.rheology import tau_eff
        te = tau_eff(fneq, rho, tau, closure)
        if tau_minus is None:
            return pulled - fneq / te[None]
        te_m = closure_tau_minus(te, tau, tau_minus)
        opp = jnp.asarray(_OPP)
        s_neq = fneq + fneq[opp]
        d_neq = fneq - fneq[opp]
        return (pulled - s_neq / (2.0 * te[None])
                - d_neq / (2.0 * te_m[None]))
    if mrt_k is not None:
        fneq = pulled - f_eq
        return pulled - jnp.tensordot(
            jnp.asarray(mrt_k, fneq.dtype), fneq, axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )
    if tau_minus is None:
        return pulled - (pulled - f_eq) / tau
    opp = jnp.asarray(_OPP)
    s_neq = (pulled + pulled[opp]) - (f_eq + f_eq[opp])
    d_neq = (pulled - pulled[opp]) - (f_eq - f_eq[opp])
    return pulled - s_neq / (2.0 * tau) - d_neq / (2.0 * tau_minus)


_UNSET = object()


def post_collision(pulled, f_eq, rho, u, tau, cc, force=_UNSET):
    """Collide + Guo source for one compiled case — the shared tail of
    every matmul-backend step. Factored so the per-cell tau closures
    (LES / non-Newtonian) compute tau_eff ONCE and feed both the BGK
    relax and the variable-rate Guo prefactor. `force` overrides
    cc.force when given (the per-cell traced field of the buoyancy
    route, engine/thermal.py); default = the case's static force."""
    if force is _UNSET:
        force = cc.force
    if cc.closure is not None:
        from lbm_jax.core.rheology import tau_eff
        fneq = pulled - f_eq
        te = tau_eff(fneq, rho, tau, cc.closure)
        te_m = None
        if cc.tau_minus is not None:   # TRT + closure: constant-Lambda
            te_m = closure_tau_minus(te, cc.tau, cc.tau_minus)
            opp = jnp.asarray(_OPP)
            s_neq = fneq + fneq[opp]
            d_neq = fneq - fneq[opp]
            f_post = (pulled - s_neq / (2.0 * te[None])
                      - d_neq / (2.0 * te_m[None]))
        else:
            f_post = pulled - fneq / te[None]
        if force is not None:
            f_post = f_post + guo_source(u, force, cc.tau,
                                         tau_local=te,
                                         tau_local_minus=te_m)
        return f_post
    f_post = collide(pulled, f_eq, tau, cc.tau_minus, cc.mrt_k)
    if force is not None:
        f_post = f_post + guo_source(u, force, cc.tau,
                                     cc.tau_minus, cc.mrt_kf)
    return f_post


def moving_bb_terms(wall_velocity):
    """(19,) Ladd momentum terms for a translating no-slip wall:
    pulled_i gains 6 w_i rho_w (e_i . u_w) over plain bounce-back
    (rho_w = 1 — the standard incompressible-scale approximation;
    the O(Ma * drho) residual is far below fp32 noise here)."""
    uw = np.asarray(wall_velocity, np.float64)
    e = D3Q19.E.astype(np.float64)
    return (6.0 * D3Q19.W.astype(np.float64) * (e @ uw)).astype(np.float32)


def streamed(f, nbr_wall, nbr_moving=None, bb_terms=None, link_q=None):
    """Pull-stream all 19 directions with fused half-way bounce-back.
    nbr_moving/bb_terms: MOVING-wall sources add the Ladd momentum term
    (moving_bb_terms) on top of the reflected population.
    link_q: Bouzidi fractional wall distances (core/bouzidi.link_q) —
    the wall branch becomes the linear interpolated bounce-back. Both
    interpolation partners are local or direction-opp(i)'s own direct
    pull, so the fused single-pass structure is unchanged."""
    pulled = [f[0]]
    for i in range(1, D3Q19.Q):
        direct = pull_one(f[i], _E[i])
        if link_q is None:
            v = jnp.where(nbr_wall[i], f[_OPP[i]], direct)
        else:
            from lbm_jax.core.bouzidi import bouzidi_coeffs
            a, b_up, b_loc = bouzidi_coeffs(link_q[i])
            # f*_opp(i) at x + e_i == opp(i)'s direct pull (XLA CSEs it)
            up = pull_one(f[_OPP[i]], _E[_OPP[i]])
            bz = a * f[_OPP[i]] + b_up * up + b_loc * f[i]
            v = jnp.where(nbr_wall[i], bz, direct)
        if nbr_moving is not None:
            v = jnp.where(nbr_moving[i], f[_OPP[i]] + bb_terms[i], v)
        pulled.append(v)
    return jnp.stack(pulled)


def make_first_step(cc: CompiledCase) -> Callable:
    """The reference's literal FIRST step: every neighbour slot — wall
    and NEE boundary alike — still holds its init feq value
    (boundary_stream has not run yet when the first `update` launch
    reads the freshly initialized d_scr, ldc.cu:645-661), so fluid
    cells pull everything directly: plain rolls, no bounce-back or NEE
    substitution. Only differs from make_step when an init velocity at
    a wall/BC cell disagrees with what the fused substitutions
    reproduce (Poiseuille's rim wall cells, whose init carries the
    parabola: Poiseulle.cu:295-341); from step 2 onward the fused step
    is exact. Opt-in for strict transient parity; steady states are
    identical either way."""
    fluid3 = cc.fluid[None]

    def first_step(f, t):
        tau = jnp.asarray(cc.tau, f.dtype)
        pulled = jnp.stack(
            [f[0]] + [pull_one(f[i], _E[i]) for i in range(1, D3Q19.Q)]
        )
        rho = jnp.sum(pulled, axis=0)
        mom = jnp.tensordot(
            jnp.asarray(_E.T.astype(f.dtype)), pulled, axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )
        mom = half_force_shift(mom, cc.force)
        u = mom / jnp.where(rho == 0, 1.0, rho)[None]
        f_eq = rho[None] * phi(u)
        f_post = post_collision(pulled, f_eq, rho, u, tau, cc)
        f_new = jnp.where(fluid3, f_post, f)
        return f_new, rho, u

    return first_step


def has_windkessel(bcs) -> bool:
    """True if any compiled BC carries a windkessel coupling (works on
    CompiledBC and SparseBC lists)."""
    return any(b.windkessel is not None for b in bcs)


def pulled_state(cc: CompiledCase, f, t, bb=None):
    """The complete pre-collision state at step t: pull-stream with
    fused bounce-back/moving walls plus every NEE/pressure BC fixup.
    Shared by make_step's hot path and the stress diagnostics
    (engine/stress.py), which must evaluate f_neq PRE-collision — the
    stored f is post-collision, where f_neq is already scaled by the
    operator's (per-mode, possibly per-cell) 1 - rate factors.
    Windkessel cases carry per-outlet state: use pulled_state_wk."""
    assert not has_windkessel(cc.bcs), (
        "case has windkessel outlets; use pulled_state_wk with the "
        "carried state"
    )
    if bb is None and cc.wall_velocity is not None:
        bb = moving_bb_terms(cc.wall_velocity)
    pulled = streamed(f, cc.nbr_wall, cc.nbr_moving, bb, cc.link_q)
    for bc in cc.bcs:
        pulled = apply_bc_fixup(pulled, f, bc, t, force=cc.force)
    return pulled


def pulled_state_wk(cc: CompiledCase, f, t, wk, bb=None, theta=None):
    """pulled_state for cases with windkessel outlets: wk is the (n_wk,)
    carried P_c vector (order = windkessel BCs within cc.bcs, see
    compile.wk_init); returns (pulled, wk'). theta: optional traced
    (n_wk, 3) RCR parameters overriding the static per-BC values
    (engine/adjoint.py's differentiable route)."""
    if bb is None and cc.wall_velocity is not None:
        bb = moving_bb_terms(cc.wall_velocity)
    pulled = streamed(f, cc.nbr_wall, cc.nbr_moving, bb, cc.link_q)
    k = 0
    wk_new = []
    for bc in cc.bcs:
        if bc.windkessel is not None:
            pulled, p = apply_bc_fixup(
                pulled, f, bc, t, force=cc.force, wk_p=wk[k],
                wk_rcr=None if theta is None else theta[k])
            wk_new.append(p)
            k += 1
        else:
            pulled = apply_bc_fixup(pulled, f, bc, t, force=cc.force)
    return pulled, jnp.stack(wk_new)


def _step_tail(cc: CompiledCase, f, pulled, force=_UNSET):
    """Moments + collide + Guo source + fluid mask — the shared tail of
    make_step / make_step_wk (identical math either way). `force`
    overrides cc.force when given (make_step_force)."""
    if force is _UNSET:
        force = cc.force
    tau = jnp.asarray(cc.tau, f.dtype)
    rho = jnp.sum(pulled, axis=0)
    mom = jnp.tensordot(
        jnp.asarray(_E.T.astype(f.dtype)), pulled, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )
    mom = half_force_shift(mom, force)
    u = mom / jnp.where(rho == 0, 1.0, rho)[None]
    f_eq = rho[None] * phi(u)
    # Divide by tau like the reference (ldc.cu:350-368) rather than
    # multiplying by a rounded 1/tau: the reciprocal's rounding is a
    # systematic per-step bias that the steady state amplifies
    # (measured ~6e-6 relative L2 after 100 steps on the 16^3 cavity
    # vs the literal transcription).
    f_post = post_collision(pulled, f_eq, rho, u, tau, cc, force=force)
    f_new = jnp.where(cc.fluid[None], f_post, f)
    return f_new, rho, u


def make_step(cc: CompiledCase) -> Callable:
    """Build the jittable fused step: (f, t) -> (f', rho, u).

    rho/u are this step's macroscopic fields, valid at fluid cells (other
    cells must be masked with cc.fluid / reconstructed from cc.rho0/u0,
    which `macro_fields` does). Windkessel cases carry per-outlet state:
    use make_step_wk."""
    assert not has_windkessel(cc.bcs), (
        "case has windkessel outlets; build the step with make_step_wk"
    )
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))

    def step(f, t):
        pulled = pulled_state(cc, f, t, bb)
        return _step_tail(cc, f, pulled)

    return step


def make_step_force(cc: CompiledCase) -> Callable:
    """The fused step with a RUNTIME force: (f, t, force) -> (f', rho,
    u) where force is a per-cell (3, X, Y, Z) traced field (or a
    constant 3-vector) applied with the same Guo scheme as
    CaseSpec.force. This is the two-way-coupling hook: the Boussinesq
    buoyancy route (engine/thermal.py) rebuilds the field from the live
    scalar every step. The plane-BC NEE fixups keep using the STATIC
    cc.force for their previous-macro half-shift (the per-cell
    perturbation at an open plane is a second-order effect there;
    thermal cavities are closed boxes with no plane BCs at all)."""
    assert not has_windkessel(cc.bcs), (
        "windkessel outlets are not wired for the runtime-force step"
    )
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))

    def step(f, t, force):
        pulled = pulled_state(cc, f, t, bb)
        return _step_tail(cc, f, pulled, force=force)

    return step


def make_step_wk(cc: CompiledCase) -> Callable:
    """The fused step for cases with windkessel (RCR) outlets:
    (f, t, wk) -> (f', rho, u, wk') with wk the (n_wk,) carried P_c
    vector (initialize with compile.wk_init(cc.bcs))."""
    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))

    def step(f, t, wk):
        pulled, wk_new = pulled_state_wk(cc, f, t, wk, bb)
        f_new, rho, u = _step_tail(cc, f, pulled)
        return f_new, rho, u, wk_new

    return step


def initial_f(cc: CompiledCase) -> jnp.ndarray:
    """f(0) = feq(rho0, u0) everywhere (ldc.cu:504-580 semantics)."""
    return cc.rho0[None] * phi(cc.u0)


def macro_fields(cc: CompiledCase, f) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reconstruct the persistent macroscopic fields the reference keeps in
    d_rho/d_ux/d_uy/d_uz: current moments at fluid cells, init values
    elsewhere (boundary cells keep their prescribed init macro forever)."""
    rho = jnp.sum(f, axis=0)
    mom = jnp.tensordot(
        jnp.asarray(_E.T.astype(f.dtype)), f, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )
    mom = half_force_shift(mom, cc.force)
    u = mom / jnp.where(rho == 0, 1.0, rho)[None]
    rho = jnp.where(cc.fluid, rho, cc.rho0)
    u = jnp.where(cc.fluid[None], u, cc.u0)
    return rho, u


__all__ = ["make_step", "make_step_wk", "make_step_force",
           "make_first_step", "initial_f",
           "macro_fields", "streamed", "pull_one", "collide",
           "guo_source", "half_force_shift", "moving_bb_terms",
           "les_tau_eff", "post_collision", "pulled_state",
           "pulled_state_wk", "windkessel_update", "has_windkessel"]
