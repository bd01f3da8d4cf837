"""MRT (multiple-relaxation-time) collision for D3Q19 — moment basis and
precomputed relaxation matrices.

Beyond-reference capability (the reference implements SRT-BGK only;
its Lectures/ notes cover the MRT/TRT family without code). Design:

- The 19 moment-basis rows are built HERE by Gram-Schmidt from the
  standard monomial set (d'Humieres et al. 2002, Phil.Trans.R.Soc. A
  360:437) evaluated on THIS repo's velocity ordering — transcribing
  the published matrix would silently break under our e_i permutation.
  Rows have definite parity under e -> -e, and Gram-Schmidt preserves
  that (cross-parity inner products vanish over the symmetric set), so
  the basis splits into 10 even + 9 odd rows.

- Equilibrium moments are defined as m_eq := M feq(rho, u) — the
  projection of the SAME second-order equilibrium every other operator
  here uses. Consequences, used as test anchors (tests/test_mrt.py):
    * all rates equal s         => exactly BGK at 1/tau = s,
    * even rates s+, odd s-     => exactly TRT (parity projectors),
    * shear rates = 1/tau       => same viscosity as BGK/TRT.

- The whole operator collapses to one precomputed 19x19 matrix
  K = M^T diag(s_k / d_k) M  (d_k = ||row_k||^2; M's rows are
  orthogonal, so M^{-1} = M^T diag(1/d_k)):
      f' = f - K (f - feq).
  On the dense/sparse/GSPMD backends that is a single tensordot, run
  at HIGHEST precision (a GPU would otherwise take it in TF32, about
  three decimal digits).

- Guo forcing composes through the moment-space prefactor
  KF = M^T diag((1 - s_k/2) / d_k) M applied to the raw source G
  (engine/step.guo_source semantics generalize: BGK/TRT are the
  special cases where KF is parity-scalar).

Default non-hydrodynamic rates follow d'Humieres et al. 2002
(s_e = 1.19, s_eps = 1.4, s_q = 1.2, s_pi = 1.4, s_m = 1.98); the
conserved rows (rho, j) get rate 0 and the five shear rows 1/tau.
"""

from __future__ import annotations

import functools

import numpy as np

from lbm_jax.core.lattice import D3Q19

#: moment-class name per basis row, in construction order.
CLASSES = (
    "rho", "e", "eps",
    "jx", "qx", "jy", "qy", "jz", "qz",
    "pxx", "pixx", "pww", "piww",
    "pxy", "pyz", "pxz",
    "mx", "my", "mz",
)

#: default relaxation rates per tunable class (d'Humieres et al. 2002).
DEFAULT_RATES = {"e": 1.19, "eps": 1.4, "q": 1.2, "pi": 1.4, "m": 1.98}

_CLASS_OF = {
    "rho": "conserved", "jx": "conserved", "jy": "conserved",
    "jz": "conserved",
    "e": "e", "eps": "eps",
    "qx": "q", "qy": "q", "qz": "q",
    "pxx": "nu", "pww": "nu", "pxy": "nu", "pyz": "nu", "pxz": "nu",
    "pixx": "pi", "piww": "pi",
    "mx": "m", "my": "m", "mz": "m",
}


@functools.lru_cache(maxsize=1)
def mrt_basis() -> tuple[np.ndarray, np.ndarray]:
    """(M (19, 19) f64, d (19,) f64): orthogonal moment basis rows over
    this repo's velocity ordering and their squared norms."""
    e = D3Q19.E.astype(np.float64)  # (19, 3)
    ex, ey, ez = e[:, 0], e[:, 1], e[:, 2]
    e2 = ex * ex + ey * ey + ez * ez
    raw = np.stack([
        np.ones(19),            # rho
        e2,                     # e (energy)
        e2 * e2,                # eps (via GS against rho, e)
        ex,                     # jx
        ex * e2,                # qx (via GS against jx)
        ey,                     # jy
        ey * e2,                # qy
        ez,                     # jz
        ez * e2,                # qz
        3.0 * ex * ex - e2,     # pxx
        (3.0 * ex * ex - e2) * e2,   # pixx
        ey * ey - ez * ez,      # pww
        (ey * ey - ez * ez) * e2,    # piww
        ex * ey,                # pxy
        ey * ez,                # pyz
        ex * ez,                # pxz
        ex * (ey * ey - ez * ez),    # mx
        ez * (ex * ex - ey * ey),    # my (parity: odd, 3rd order)
        ey * (ez * ez - ex * ex),    # mz
    ])
    m = raw.copy()
    for k in range(19):
        for j in range(k):
            dj = float(m[j] @ m[j])
            if dj > 0:
                m[k] = m[k] - (float(m[k] @ m[j]) / dj) * m[j]
        # keep integer-ish scaling stable: no normalization (d carries it)
    d = np.einsum("ki,ki->k", m, m)
    assert (d > 1e-9).all(), "degenerate moment basis"
    # orthogonality sanity
    g = m @ m.T
    assert np.abs(g - np.diag(d)).max() < 1e-9
    return m, d


def _rates_vector(tau: float, rates: dict | None) -> np.ndarray:
    r = dict(DEFAULT_RATES)
    if rates:
        unknown = set(rates) - set(DEFAULT_RATES)
        if unknown:
            raise ValueError(f"unknown MRT rate classes {sorted(unknown)}; "
                             f"known: {sorted(DEFAULT_RATES)}")
        r.update(rates)
    s_nu = 1.0 / tau
    out = np.zeros(19)
    for k, name in enumerate(CLASSES):
        cls = _CLASS_OF[name]
        if cls == "conserved":
            out[k] = 0.0
        elif cls == "nu":
            out[k] = s_nu
        else:
            out[k] = r[cls]
    return out


def mrt_matrices(tau: float, rates: dict | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(K, KF) f64 19x19: the collision matrix f' = f - K (f - feq) and
    the Guo-source prefactor S_applied = KF @ G (see module docstring).

    For the conserved rows s = 0: K annihilates them (mass/momentum
    exactly conserved regardless of f_neq) and KF passes the source's
    momentum through with the exact (1 - 0/2) = 1 weight Guo requires.
    """
    m, d = mrt_basis()
    s = _rates_vector(tau, rates)
    k = (m.T * (s / d)) @ m
    kf = (m.T * ((1.0 - 0.5 * s) / d)) @ m
    return k, kf


__all__ = ["mrt_basis", "mrt_matrices", "CLASSES",
           "DEFAULT_RATES"]
