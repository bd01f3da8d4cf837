"""Differentiable-solver (adjoint) tests — engine/adjoint.py.

The functional step + lax.scan rollout make the whole solver
reverse-mode differentiable (no reference analogue: coronary.cu's
in-place CUDA kernels cannot be differentiated). Anchors:

  * make_step_theta with theta = the static RCR values reproduces
    make_step_wk state-for-state (the traced-parameter route changes
    no math),
  * the remat'd rollout is chunking-invariant (same forward state for
    any remat_chunk),
  * jax.grad through a multi-step rollout matches central finite
    differences (the gradient is the EXACT discrete adjoint),
  * gradient descent on log Rd moves a 4-outlet coronary's flow split
    toward a prescribed target (the FFR-CT outlet-calibration task).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.engine.adjoint import (fit_windkessel, flow_split,
                                    make_step_theta, outlet_fluxes,
                                    rollout, wk_params)
from lbm_jax.engine.compile import compile_case, wk_init
from lbm_jax.engine.step import initial_f, make_step_wk

_WK = (5e-4, 24000.0, 2.5e-3)  # Rp, C, Rd (lattice)


def test_step_theta_matches_static_wk():
    """theta == the compiled-in RCR values: the traced-parameter step is
    the static step (same expression tree, constants traced instead of
    folded)."""
    spec = get_case("poiseuille", n=16, windkessel=_WK)
    cc = compile_case(spec)
    step_s = jax.jit(make_step_wk(cc))
    step_t = jax.jit(make_step_theta(cc))
    theta = jnp.asarray(wk_params(cc))
    f_s = f_t = initial_f(cc)
    wk_s = wk_t = jnp.asarray(wk_init(cc.bcs))
    for t in range(30):
        f_s, _, _, wk_s = step_s(f_s, t, wk_s)
        f_t, wk_t = step_t(f_t, t, wk_t, theta)
    np.testing.assert_allclose(np.asarray(wk_t), np.asarray(wk_s),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(np.asarray(f_t), np.asarray(f_s),
                               rtol=1e-6, atol=1e-9)


def test_rollout_remat_chunking_invariant():
    """The two-level remat scan's step indexing: any chunk split yields
    the same forward state (t0 + i must walk 0..n-1 exactly)."""
    spec = get_case("poiseuille", n=12, windkessel=_WK)
    cc = compile_case(spec)
    theta = jnp.asarray(wk_params(cc))
    f_a, wk_a = rollout(cc, theta, 60, remat_chunk=10)
    f_b, wk_b = rollout(cc, theta, 60, remat_chunk=30)
    np.testing.assert_array_equal(np.asarray(f_a), np.asarray(f_b))
    np.testing.assert_array_equal(np.asarray(wk_a), np.asarray(wk_b))
    # and matches the plain static-step evolution
    step_s = jax.jit(make_step_wk(cc))
    f, wk = initial_f(cc), jnp.asarray(wk_init(cc.bcs))
    for t in range(60):
        f, _, _, wk = step_s(f, t, wk)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(f),
                               rtol=1e-6, atol=1e-9)


def test_adjoint_gradient_matches_finite_difference():
    """d P_c(final) / d log Rd through a 60-step rollout: reverse-mode
    equals central finite differences — the exact discrete adjoint of
    the coupled LBM + windkessel system, boundary fixups and all."""
    spec = get_case("poiseuille", n=12, windkessel=_WK)
    cc = compile_case(spec)
    base = jnp.asarray(wk_params(cc))

    def loss(log_rd):
        theta = base.at[0, 2].set(jnp.exp(log_rd))
        _, wk = rollout(cc, theta, 60, remat_chunk=20)
        return wk[0]

    g = jax.jit(jax.grad(loss))
    x0 = jnp.log(base[0, 2])
    auto = float(g(x0))
    h = 0.1
    lf = jax.jit(loss)
    fd = (float(lf(x0 + h)) - float(lf(x0 - h))) / (2 * h)
    assert auto != 0.0
    np.testing.assert_allclose(auto, fd, rtol=2e-2)


def test_outlet_fluxes_match_coupling_q():
    """outlet_fluxes reads the same footprint/sign/macro the coupling's
    RCR ODE integrates: at the rollout end, one more windkessel update
    driven by outlet_fluxes' q reproduces the carried P_c'."""
    from lbm_jax.engine.step import windkessel_update

    spec = get_case("poiseuille", n=12, windkessel=_WK)
    cc = compile_case(spec)
    theta = jnp.asarray(wk_params(cc))
    f, wk = rollout(cc, theta, 40, remat_chunk=20)
    q = outlet_fluxes(cc, f)
    step_t = jax.jit(make_step_theta(cc))
    _, wk_next = step_t(f, 40, wk, theta)
    p_pred, _ = windkessel_update(wk[0], q[0], _WK)
    np.testing.assert_allclose(float(wk_next[0]), float(p_pred),
                               rtol=1e-6)


@pytest.mark.slow
def test_fit_windkessel_moves_coronary_split_to_target():
    """The clinical calibration loop: 4 RCR outlets on the synthetic
    coronary tree, gradient descent on log Rd drives the computed flow
    split toward the measured target — the quantity the reference
    HARD-CODES as outlet speeds (coronary.cu:795-942). Asserts real
    progress (loss down >=5x, every split component closer) rather than
    exact convergence to keep the horizon CPU-cheap."""
    wk = [(1e-4, 5e3, 2e-3)] * 4
    spec = get_case("coronary", shape=(48, 24, 40), radius=5,
                    windkessel=wk)
    cc = compile_case(spec)
    theta0 = jnp.asarray(wk_params(cc))
    f0, _ = rollout(cc, theta0, 200, remat_chunk=25)
    split0 = np.asarray(flow_split(cc, f0))
    target = np.asarray([0.40, 0.30, 0.18, 0.12], np.float32)
    loss0 = float(np.sum((split0 - target) ** 2))

    theta, hist = fit_windkessel(spec, target, n_steps=200, iters=10,
                                 lr=0.35, remat_chunk=25)
    loss_end, split_end = hist[-1]
    assert loss_end < loss0 / 5, (loss0, loss_end)
    assert np.abs(split_end - target).max() < np.abs(split0 - target).max()
    # fitted resistances follow the physics: more flow demanded =>
    # lower distal resistance. Only the TOTAL path resistance ordering
    # is cleanly determined — in-tree segments differ per outlet and
    # 10 Adam iterations leave near-ties among the low-flow pair — so
    # assert the coarse structure: the largest-flow outlet gets the
    # smallest Rd, and both low-flow outlets out-resist both
    # high-flow ones.
    rd = theta[:, 2]
    order = np.argsort(-target)            # high flow -> low flow
    assert rd[order[0]] == rd.min()
    assert rd[order[2:]].min() > rd[order[:2]].max()


# ---- non-RCR parameter family: diffusivity from a washout curve ----
# (VERDICT r4 next-#9: trace tau_g through the transport rollout)

def _frozen_transport(n=14, D=0.03):
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.engine.scalar import ScalarTransport

    spec = get_case("poiseuille", n=n)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=300, time_save=100, verbose=False)
    u = np.asarray(sim.macro()[1])
    return ScalarTransport(spec, u, D=D, inlet_c={0: 1.0})


def test_transport_rollout_matches_run():
    """transport_rollout at the instance's own tau_g reproduces
    ScalarTransport.run's recorded series exactly (same pass, same
    scan structure up to remat chunking)."""
    from lbm_jax.engine.adjoint import transport_rollout

    st = _frozen_transport()
    series = transport_rollout(st, st.tau_g, 50, [1], remat_chunk=25)
    ref = st.run(50, record=[1])
    np.testing.assert_allclose(np.asarray(series), ref, rtol=2e-6,
                               atol=1e-7)


def test_diffusivity_gradient_matches_finite_difference():
    """d(series-mismatch)/d(log(tau_g - 1/2)) against central FD."""
    from lbm_jax.engine.adjoint import transport_rollout

    st = _frozen_transport(D=0.03)
    obs = jnp.asarray(
        transport_rollout(st, 0.5 + 4 * 0.05, 40, [1], remat_chunk=20))

    def loss(x):
        s = transport_rollout(st, 0.5 + jnp.exp(x), 40, [1],
                              remat_chunk=20)
        return jnp.mean((s - obs) ** 2)

    x0 = jnp.log(jnp.float32(4 * 0.03))
    g = float(jax.grad(loss)(x0))
    eps = 1e-2
    fd = (float(loss(x0 + eps)) - float(loss(x0 - eps))) / (2 * eps)
    assert g == pytest.approx(fd, rel=2e-2), (g, fd)


@pytest.mark.slow
def test_fit_diffusivity_recovers_true_D():
    """Synthesize a washout curve at D_true, start the fit 2.5x off,
    and recover D within a few percent — the contrast-curve inverse
    problem (fit_diffusivity)."""
    from lbm_jax.engine.adjoint import fit_diffusivity, transport_rollout

    d_true = 0.04
    st = _frozen_transport(D=d_true)
    obs = np.asarray(transport_rollout(st, 0.5 + 4 * d_true, 100, [1],
                                       remat_chunk=25))
    d_fit, hist = fit_diffusivity(st, obs, [1], n_steps=100, iters=40,
                                  lr=0.15, D0=0.1)
    assert d_fit == pytest.approx(d_true, rel=0.05), (d_fit, hist[-1])
    assert hist[-1][0] < hist[0][0] * 1e-2, "loss must collapse"
