"""D3Q19 lattice: velocity set, weights, opposite pairs, equilibrium, moments.

The velocity ordering matches the CUDA reference's implicit convention
(pull offsets at Lid_driven_cavity/ldc.cu:204-313, moment sums at
ldc.cu:320-322, bounce-back pairs at ldc.cu:184-201):

  0        : rest
  1..6     : +x, -x, +y, -y, +z, -z
  7..10    : (+1,+1,0), (+1,-1,0), (-1,+1,0), (-1,-1,0)
  11..14   : (+1,0,+1), (+1,0,-1), (-1,0,+1), (-1,0,-1)
  15..18   : (0,+1,+1), (0,-1,+1), (0,+1,-1), (0,-1,-1)

All compute is fp32 — the reference is single precision throughout
(thesis section 4.4) and LBM stability/mass conservation depend on it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


def _build_velocities() -> np.ndarray:
    e = np.array(
        [
            [0, 0, 0],
            [1, 0, 0], [-1, 0, 0],
            [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1],
            [1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0],
            [1, 0, 1], [1, 0, -1], [-1, 0, 1], [-1, 0, -1],
            [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
        ],
        dtype=np.int32,
    )
    return e


@dataclasses.dataclass(frozen=True)
class _D3Q19:
    """Immutable D3Q19 constants (NumPy on host; cast to jnp at use sites)."""

    Q: int = 19
    E: np.ndarray = dataclasses.field(default_factory=_build_velocities)
    W: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12, dtype=np.float32
        )
    )
    OPP: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [0, 2, 1, 4, 3, 6, 5, 10, 9, 8, 7, 14, 13, 12, 11, 18, 17, 16, 15],
            dtype=np.int32,
        )
    )

    def dirs_into(self, axis: int, sign: int) -> np.ndarray:
        """Direction indices i with E[i, axis] * sign > 0.

        These are the populations a boundary plane with inward normal
        `sign` along `axis` must prescribe (the sets hard-coded per case in
        the reference, e.g. {4,8,10,16,18} for -y at ldc.cu:391-456).
        """
        return np.nonzero(self.E[:, axis] * sign > 0)[0].astype(np.int32)


D3Q19 = _D3Q19()

_EF = D3Q19.E.astype(np.float32)  # (19, 3)
_W = D3Q19.W  # (19,)
# f64 master weights, for the float64 algebraic-identity proof runs
# (tests/test_reference_parity.py); the runtime path stays fp32.
_W64 = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
                dtype=np.float64)


def phi(u, dirs=None):
    """Velocity-dependent part of the equilibrium: feq = rho * phi(u).

    phi_i(u) = w_i * (1 + 3 e_i.u + 4.5 (e_i.u)^2 - 1.5 |u|^2)

    This is the single vectorized form of the 19 per-direction expressions
    the reference expands by hand (ldc.cu:330-348 and :553-571 — both are
    algebraically this formula).

    u: (3, ...) velocity field. Returns (Q', ...) with Q' = len(dirs) or 19.
    """
    u = jnp.asarray(u)
    if u.dtype != jnp.float64:  # default fp32 path (reference precision)
        u = u.astype(jnp.float32)
    wtab = _W if u.dtype == jnp.float32 else _W64
    e = D3Q19.E.astype(u.dtype)
    w = wtab.astype(u.dtype)
    if dirs is not None:
        e = e[np.asarray(dirs)]
        w = w[np.asarray(dirs)]
    # precision pinned: a GPU's default float32 dot may run in TF32; the
    # (Q', 3) contraction must stay fp32 (reference is fp32 throughout).
    cu = jnp.tensordot(
        jnp.asarray(e), u, axes=([1], [0]), precision=jax.lax.Precision.HIGHEST
    )  # (Q', ...)
    usq = jnp.sum(u * u, axis=0)  # (...)
    w = jnp.asarray(w).reshape((-1,) + (1,) * usq.ndim)
    return w * (1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq)


def feq(rho, u, dirs=None):
    """Second-order BGK equilibrium distribution, feq_i = rho * phi_i(u).

    rho: (...); u: (3, ...). Returns (Q', ...).
    """
    p = phi(u, dirs)
    return jnp.asarray(rho, p.dtype)[None] * p


def moments(f):
    """Macroscopic density and velocity from distributions.

    f: (19, ...). Returns (rho (...), u (3, ...)). Matches the moment sums
    at ldc.cu:316-322 (u = sum_i e_i f_i / rho).
    """
    f = jnp.asarray(f)
    if f.dtype != jnp.float64:
        f = f.astype(jnp.float32)
    rho = jnp.sum(f, axis=0)
    mom = jnp.tensordot(
        jnp.asarray(D3Q19.E.T.astype(f.dtype)), f, axes=([1], [0]),
        precision=jax.lax.Precision.HIGHEST,
    )  # (3, ...)
    return rho, mom / rho


__all__ = ["D3Q19", "feq", "phi", "moments"]
