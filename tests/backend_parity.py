"""Shared cross-backend checks: the sparse gather step and the
multi-device paths against the single-device dense step.

Each check runs the case through Simulation (the entry point users
call), so windkessel carries, series inlets, closures and forces take
the same route as in production.
"""

import numpy as np

from lbm_jax.engine.runner import Simulation

# fp32 throughout and HIGHEST-precision moments: two backends differ
# only in the order of a few sums, far below these bounds.
RTOL, ATOL = 3e-6, 1e-7


def run_sim(spec, nsteps, **kw):
    """(f in the portable (19, X, Y, Z) layout, windkessel state or
    None) after nsteps through Simulation(spec, **kw)."""
    sim = Simulation(spec, **kw)
    sim.run(max_steps=nsteps, time_save=nsteps, verbose=False)
    wk = None if sim.wk is None else np.asarray(sim.wk)
    return np.asarray(sim.f_standard()), wk


def assert_matches_dense(spec, nsteps=4, rtol=RTOL, atol=ATOL, **kw):
    """Simulation(spec, **kw) agrees with the single-device dense step
    on every live cell and in the windkessel state after nsteps."""
    f_ref, wk_ref = run_sim(spec, nsteps, backend="xla")
    f, wk = run_sim(spec, nsteps, **kw)
    live = np.asarray(spec.mask) != 0
    assert np.isfinite(f[:, live]).all()
    np.testing.assert_allclose(f[:, live], f_ref[:, live],
                               rtol=rtol, atol=atol)
    if wk_ref is not None:
        np.testing.assert_allclose(wk, wk_ref, rtol=rtol, atol=atol)


def assert_sparse_matches_dense(spec, nsteps=4, rtol=RTOL, atol=ATOL):
    assert_matches_dense(spec, nsteps, rtol, atol, backend="sparse")
