"""Field-level parity vs the reference solvers' exact numerics.

BASELINE.md accuracy target: "<1e-5 relative L2 vs CUDA-reference steady
fields". No GPU exists here, so the CUDA fields are produced by
tests/reference_oracle.py — a literal NumPy transcription of the
reference's two-kernel step with the reference's own expression ordering
(see the oracle's module docstring for the determinism argument).

These tests run the fused single-pass engine and the oracle side by side
for O(100) steps — long enough for every BC variant to act on every
consumer plane many times — and assert the velocity/density fields agree
to fp32 round-off, far below the 1e-5 target. This validates, against
the reference's literal numerics (update: Poiseulle.cu:384-583, ldc's
pre-collision wall pass ldc.cu:75-202, boundary_stream NEE blocks):

  - the one-pass fusion theorem (engine/compile.py docstring),
  - every NEE variant: moving lid (ldc.cu:391-456), velocity in/out with
    extrapolated rho (Poiseulle.cu:748-891), measured-map inlet +
    pressure outlet rho*=1 (bifurcation.cu:877-1021), fixed rho+u inlet
    and fixed-u multi-outlets (coronary.cu:716-942),
  - ldc's literal transient ordering (ldc_mode=True): the engine's
    post-collision ordering yields the same consumed values.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.step import (
    initial_f,
    macro_fields,
    make_first_step,
    make_step,
)

from reference_oracle import oracle_from_spec


def run_engine(spec, steps):
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    # The reference's first step pulls init values from every neighbour
    # (wall slots are only overwritten at the end of step 1); the opt-in
    # literal first step reproduces that transient exactly.
    first = jax.jit(make_first_step(cc))
    f = initial_f(cc)
    for k in range(steps):
        f, rho, u = (first if k == 0 else step)(f, np.int32(k))
    rho, u = macro_fields(cc, f)
    return np.asarray(rho), np.asarray(u), np.asarray(cc.fluid)


def rel_l2(a, b, where3=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = np.sqrt(np.sum((a - b) ** 2))
    den = np.sqrt(np.sum(b**2))
    return num / max(den, 1e-300)


def compare(spec, steps, ldc_mode=False, tol=1e-5):
    f0 = np.asarray(initial_f(compile_case(spec)))
    rho_e, u_e, fluid = run_engine(spec, steps)
    o = oracle_from_spec(spec, ldc_mode=ldc_mode, f0=f0).run(steps)
    u_o = np.stack([o.ux, o.uy, o.uz])
    fl3 = np.broadcast_to(fluid, u_o.shape)
    err_u = rel_l2(u_e[fl3], u_o[fl3])
    err_rho = rel_l2(rho_e[fluid], o.rho[fluid])
    assert np.all(np.isfinite(u_o[fl3]))
    assert err_u < tol, f"velocity rel L2 {err_u:.3e} >= {tol}"
    assert err_rho < tol, f"density rel L2 {err_rho:.3e} >= {tol}"
    return err_u, err_rho


def test_lid_cavity_matches_reference_oracle():
    """Lid NEE + ldc's literal pre-collision wall ordering (ldc_mode)."""
    spec = get_case("lid_driven_cavity", n=16, max_steps=200)
    compare(spec, steps=200, ldc_mode=True)


def test_algebraic_identity_f64():
    """PROOF that the fused engine computes the same map as the
    reference's two-kernel step: in float64 the two implementations agree
    to ~1e-13 after 200 steps, so every fp32 difference measured by the
    other tests is pure round-off between algebraically identical
    schemes (different summation orders / reciprocal rounding), not a
    modelling difference."""
    spec = get_case("lid_driven_cavity", n=16, max_steps=200)
    with jax.enable_x64(True):
        cc = compile_case(spec, dtype=np.float64)
        step = jax.jit(make_step(cc))
        first = jax.jit(make_first_step(cc))
        f = initial_f(cc)
        assert f.dtype == np.float64
        for k in range(200):
            f, rho, u = (first if k == 0 else step)(f, np.int32(k))
        u_e = np.asarray(u)
        fluid = np.asarray(cc.fluid)
        o = oracle_from_spec(spec, ldc_mode=True,
                             f0=np.asarray(initial_f(cc)),
                             dtype=np.float64).run(200)
    u_o = np.stack([o.ux, o.uy, o.uz])
    fl3 = np.broadcast_to(fluid, u_o.shape)
    err = rel_l2(u_e[fl3], u_o[fl3])
    assert err < 1e-11, f"f64 engine-vs-oracle rel L2 {err:.3e}"


def test_lid_cavity_post_collision_ordering_equivalent():
    """The later solvers' post-collision wall ordering produces the same
    consumed values on the cavity (the engine uses this ordering for all
    cases; see engine/step.py transient-ordering note)."""
    spec = get_case("lid_driven_cavity", n=16, max_steps=120)
    compare(spec, steps=120, ldc_mode=False)


def test_poiseuille_matches_reference_oracle():
    """Parabolic velocity inlet+outlet NEE with extrapolated rho."""
    spec = get_case("poiseuille", n=20, max_steps=200)
    compare(spec, steps=200)


@pytest.mark.skipif(
    not os.path.exists("/root/reference/bifurcation/geo.txt"),
    reason="reference geometry not available",
)
def test_bifurcation_matches_reference_oracle():
    """Real carotid geometry: measured-map velocity inlet + pressure
    outlet (rho*=1, u extrapolated) + file-derived wall set."""
    spec = get_case("bifurcation", max_steps=100)
    compare(spec, steps=100)


def test_coronary_matches_reference_oracle():
    """Synthetic tree: fixed rho+u inlet, fixed-u main outlet, three
    fixed-u sub-outlets (labels 5/6/7) on z-planes."""
    spec = get_case("coronary", shape=(48, 24, 40), radius=6, max_steps=100)
    compare(spec, steps=100)
