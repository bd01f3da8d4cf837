"""Local (per-cell) effective-relaxation closures: Smagorinsky LES and
shear-rate-dependent (non-Newtonian) rheology.

Every closure here consumes the same scalar the LES path already
builds: P = sqrt(2 Pi:Pi) with the non-equilibrium momentum flux
Pi_ab = sum_i e_ia e_ib f_neq_i — a non-Newtonian closure therefore
costs exactly what LES already costs plus the per-cell nu(gamma)
arithmetic.

The local shear-rate magnitude follows from the standard second-moment
relation S_ab = -3/(2 rho tau) Pi_ab (cs^2 = 1/3, dt = 1):

    gamma_dot := sqrt(2 S:S) = 3 P / (2 rho tau_eff)

so a generalized-Newtonian fluid nu(gamma_dot) closes into a per-cell
fixed point

    tau_eff = 1/2 + 3 nu( 3 P / (2 rho tau_eff) )

solved by a statically-unrolled Picard iteration (the map is a
contraction for the shear-thinning exponents used in hemodynamics;
`iters` bounds it and `tau_bounds` clips each iterate for stability —
clipping nu is standard practice for power-law fluids, whose apparent
viscosity diverges at zero shear when n < 1).

Beyond-reference: the reference solvers are Newtonian and laminar-only
(constant tau compiled into each .cu, e.g. /root/reference/
coronary_cfd/coronary.cu:24), while blood is shear-thinning; the
Carreau(-Yasuda) model implemented here is the standard
generalized-Newtonian closure of the hemodynamics LBM literature
(Boyd, Buick & Green 2007-style second-moment shear-rate evaluation —
local, no velocity gradients or finite differences).

Closure canonical form (static, hashable — safe as a jit constant):

    ('smag', cs)                                  Smagorinsky LES
    ('plaw', K, n, te_lo, te_hi, iters)           nu = K gamma^(n-1)
    ('cy', nu0, nu_inf, lam, n, a, te_lo, te_hi, iters)
        nu = nu_inf + (nu0-nu_inf) (1 + (lam gamma)^a)^((n-1)/a)
        (a = 2 is Carreau; general a is Carreau-Yasuda)
    ('casson', nu_c, tau_y, te_lo, te_hi, iters)
        nu = (sqrt(nu_c) + sqrt(tau_y/gamma))^2  (yield stress tau_y,
        kinematic: stress/rho; the plug core rides the te_hi clip —
        the standard regularization of yield-stress LBM)

All parameters are in lattice units (nu_lat = (tau-1/2)/3; convert
physical Carreau constants through core/units.py).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

_TE_LO = 0.5005     # default tau_eff clip: nu >= 1.67e-4 lattice units
_TE_HI = 20.0       # ... and nu <= 6.5 (huge, but finite: plug cores)
_ITERS = 8          # Picard iterations (statically unrolled)
_TINY = np.float32(1e-30)


def normalize_closure(smagorinsky_cs, rheology: Optional[dict]):
    """Validate and canonicalize CaseSpec.(smagorinsky_cs, rheology)
    into one static closure tuple (or None). Exactly one of the two may
    be set."""
    if smagorinsky_cs is not None and rheology is not None:
        raise ValueError("smagorinsky_cs and rheology are exclusive "
                         "(both are per-cell tau closures)")
    if smagorinsky_cs is not None:
        cs = float(smagorinsky_cs)
        assert cs > 0.0
        return ("smag", cs)
    if rheology is None:
        return None
    r = dict(rheology)
    model = r.pop("model")

    def req(key):
        try:
            return r.pop(key)
        except KeyError:
            raise ValueError(
                f"rheology model {model!r} requires {key!r}") from None
    lo, hi = r.pop("tau_bounds", (_TE_LO, _TE_HI))
    lo, hi = float(lo), float(hi)
    assert 0.5 < lo < hi, "tau_bounds must satisfy 0.5 < lo < hi"
    iters = int(r.pop("iters", _ITERS))
    assert iters >= 1
    if model == "power_law":
        k, n = float(req("K")), float(req("n"))
        assert k > 0.0 and n > 0.0
        assert not r, f"unknown power_law keys: {sorted(r)}"
        return ("plaw", k, n, lo, hi, iters)
    if model == "casson":
        nu_c = float(req("nu_c"))
        tau_y = float(req("tau_y"))
        assert nu_c > 0.0 and tau_y >= 0.0
        assert not r, f"unknown casson keys: {sorted(r)}"
        return ("casson", nu_c, tau_y, lo, hi, iters)
    if model in ("carreau", "carreau_yasuda"):
        nu0 = float(req("nu0"))
        nu_inf = float(req("nu_inf"))
        lam = float(req("lam"))
        n = float(req("n"))
        a = float(r.pop("a", 2.0))
        assert nu0 > 0.0 and nu_inf > 0.0 and lam >= 0.0
        assert n > 0.0 and a > 0.0
        assert not r, f"unknown carreau keys: {sorted(r)}"
        return ("cy", nu0, nu_inf, lam, n, a, lo, hi, iters)
    raise ValueError(f"unknown rheology model {model!r} "
                     "(power_law | carreau | carreau_yasuda | casson)")


def carreau_blood(units, rho: float = 1060.0, mu0: float = 0.056,
                  mu_inf: float = 0.00345, lam: float = 3.313,
                  n: float = 0.3568, a: float = 2.0, **kw) -> dict:
    """CaseSpec.rheology dict for physiological blood in the given
    UnitSystem — the Carreau fit of Cho & Kensey (1991), the standard
    constants of the hemodynamics CFD literature (mu0 = 56 mPa.s,
    mu_inf = 3.45 mPa.s, lambda = 3.313 s, n = 0.3568).

    Conversion: nu_lat = nu_phys / (CH C_U), lam_lat = lam_phys / C_T.
    At the coronary case's scales (CH = 6.56e-5 m, C_U = 2.47 m/s)
    blood spans tau_eff in about [0.56, 1.5] with the Carreau
    transition landing right in the resolved shear-rate band — i.e.
    the non-Newtonian correction is physically active, not decorative.
    Extra keys (tau_bounds, iters) pass through."""
    nu_scale = units.CH * units.C_U  # lattice kinematic-viscosity unit
    return {"model": "carreau", "nu0": mu0 / rho / nu_scale,
            "nu_inf": mu_inf / rho / nu_scale,
            "lam": lam / units.C_T, "n": n, "a": a, **kw}


def nu_of_gamma(gamma, closure):
    """Apparent kinematic viscosity nu(gamma_dot) of a rheology closure
    (NumPy, unclipped — tests and analytic anchors)."""
    gamma = np.asarray(gamma, np.float64)
    if closure[0] == "plaw":
        k, n = closure[1], closure[2]
        return k * gamma ** (n - 1.0)
    if closure[0] == "cy":
        nu0, nu_inf, lam, n, a = closure[1:6]
        return nu_inf + (nu0 - nu_inf) * (
            1.0 + (lam * gamma) ** a) ** ((n - 1.0) / a)
    if closure[0] == "casson":
        nu_c, tau_y = closure[1], closure[2]
        return (np.sqrt(nu_c) + np.sqrt(tau_y / gamma)) ** 2
    raise ValueError(f"{closure[0]!r} has no nu(gamma)")


def tau_eff_from_p(p, inv_rho, tau0, closure):
    """Per-cell effective relaxation time from P = sqrt(2 Pi:Pi) and
    1/rho. jnp, fp32 constants."""
    kind = closure[0]
    t0 = jnp.asarray(tau0, jnp.float32)  # python float or traced scalar
    if kind == "smag":
        # closed form (Hou et al.): nu_t = (Cs D)^2 |S|, D = 1 cell
        k = np.float32(18.0 * closure[1] * closure[1])
        return np.float32(0.5) * (
            t0 + jnp.sqrt(t0 * t0 + k * p * inv_rho))
    # generalized-Newtonian fixed point te = 1/2 + 3 nu(g0/te),
    # g0 = (3/2) P / rho = gamma_dot * te
    g0 = np.float32(1.5) * p * inv_rho
    te = jnp.zeros_like(p) + t0
    if kind == "plaw":
        _, k, n, lo, hi, iters = closure
        em1 = np.float32(n - 1.0)
        c3k = np.float32(3.0 * k)
        for _ in range(int(iters)):
            lg = jnp.log(jnp.maximum(g0 / te, _TINY))
            te = jnp.clip(np.float32(0.5) + c3k * jnp.exp(em1 * lg),
                          np.float32(lo), np.float32(hi))
        return te
    if kind == "cy":
        _, nu0, nu_inf, lam, n, a, lo, hi, iters = closure
        dnu3 = np.float32(3.0 * (nu0 - nu_inf))
        base = np.float32(0.5 + 3.0 * nu_inf)
        ea = np.float32(a)
        ex = np.float32((n - 1.0) / a)
        lam_f = np.float32(lam)
        for _ in range(int(iters)):
            if a == 2.0:
                # standard Carreau: (lam gamma)^2 is an exact square —
                # one transcendental pair fewer per iteration
                z = lam_f * g0 / te
                x = z * z
            else:
                lg = jnp.log(jnp.maximum(lam_f * g0 / te, _TINY))
                x = jnp.exp(ea * lg)          # (lam gamma)^a
            nu3 = dnu3 * jnp.exp(ex * jnp.log1p(x))
            te = jnp.clip(base + nu3, np.float32(lo), np.float32(hi))
        return te
    if kind == "casson":
        # nu = (sqrt(nu_c) + sqrt(tau_y/gamma))^2 with gamma = g0/te
        # makes the fixed point QUADRATIC in s = sqrt(te):
        #   te = B + C sqrt(te/g0) + D te/g0,  B = 1/2 + 3 nu_c,
        #   C = 6 sqrt(nu_c tau_y), D = 3 tau_y
        # => (1 - D/g0) s^2 - (C/sqrt(g0)) s - B = 0, solved in CLOSED
        # FORM (no Picard loop; `iters` is ignored). When D/g0 >= 1
        # there is no finite root — the plug core — and te rides the
        # hi clip, the standard yield-stress regularization. tau_y = 0
        # degenerates exactly to Newtonian nu_c.
        _, nu_c, tau_y, lo, hi, _ = closure
        b = np.float32(0.5 + 3.0 * nu_c)
        cc = np.float32(6.0 * np.sqrt(nu_c * tau_y))
        dd = np.float32(3.0 * tau_y)
        g = jnp.maximum(g0, _TINY)
        a = np.float32(1.0) - dd / g
        c = cc / jnp.sqrt(g)
        disc = c * c + np.float32(4.0) * a * b
        s = ((c + jnp.sqrt(jnp.maximum(disc, np.float32(0.0))))
             / (np.float32(2.0) * jnp.maximum(a, _TINY)))
        te = jnp.where(a > 0, s * s, np.float32(hi))
        return jnp.clip(te, np.float32(lo), np.float32(hi))
    raise ValueError(f"unknown closure kind {kind!r}")


def tau_eff(fneq, rho, tau, closure):
    """Dense-path wrapper: assemble P = sqrt(2 Pi:Pi) from the full
    (19, ...) f_neq, then the per-cell tau_eff. Subsumes the former
    engine/step.les_tau_eff (closure ('smag', cs))."""
    from lbm_jax.core.lattice import D3Q19
    import jax
    e = D3Q19.E.astype(np.float32)
    ee = np.stack([np.outer(ei, ei) for ei in e])
    pi = jnp.tensordot(jnp.asarray(ee), fneq, axes=([0], [0]),
                       precision=jax.lax.Precision.HIGHEST)  # (3,3,...)
    p = jnp.sqrt(2.0 * jnp.sum(pi * pi, axis=(0, 1)))
    inv_rho = np.float32(1.0) / jnp.where(rho == 0, np.float32(1.0), rho)
    return tau_eff_from_p(p, inv_rho, tau, closure)


__all__ = ["normalize_closure", "nu_of_gamma", "tau_eff_from_p",
           "tau_eff", "carreau_blood"]
