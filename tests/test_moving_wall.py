"""Moving-wall (Ladd bounce-back) tests — CaseSpec.wall_velocity.

Beyond-reference capability: the reference's README excludes moving
boundaries ("moving boundary ... NOT considered",
/root/reference/README.md:2). MOVING-labeled cells
(geometry.mask.CellType.MOVING) act as translating no-slip walls:
pulled_i = f_opp + 6 w_i rho0 (e_i . u_w) (engine/step.moving_bb_terms).

Covered:
  * plane Couette flow: the linear profile is an EXACT steady solution
    of LBM + half-way bounce-back, so both BGK and TRT reproduce it to
    fp32 rounding (measured <=2e-5 of U),
  * cross-backend equivalence (dense / sparse, incl. the
    all-walls-moving z-fixup case),
  * the lid-driven cavity's lid='bounceback' variant converges to the
    same flow as the reference's NEE lid, with the difference shrinking
    ~first-order in resolution (the half-cell lid-position offset);
    the external Ghia anchor for the bounce-back lid lives in
    tests/test_benchmarks.py (parametrized over both lid schemes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.runner import Simulation
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.engine.step import initial_f, make_step
from lbm_jax.geometry.mask import CellType

from backend_parity import assert_sparse_matches_dense

_UNITS = UnitSystem(CH=1e-4, C_U=1.0, C_rho=1000.0)


def _dense_run(cc, f0, nsteps):
    step = jax.jit(make_step(cc))
    f = f0
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(f)


@pytest.mark.parametrize("tau,collision", [(0.8, "bgk"), (1.3, "trt")])
def test_couette_exact_linear_profile(tau, collision):
    """Static wall at x=0, moving wall at x=nx-1 (u_w along y), y/z
    periodic: steady u_y(x) = U (x - 1/2)/W is exact for half-way BB."""
    nx, ny, nz = 10, 8, 8
    U = 0.05
    geo = np.zeros((nx, ny, nz), np.int32)
    geo[0] = CellType.WALL
    geo[nx - 1] = CellType.MOVING
    geo[1:nx - 1] = CellType.FLUID
    spec = CaseSpec(name="couette", shape=(nx, ny, nz), tau=tau,
                    units=_UNITS, mask=geo, boundaries=[],
                    wall_velocity=(0.0, U, 0.0), collision=collision)
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    u = None
    for t in range(4000):
        f, rho, u = step(f, jnp.int32(t))
    uy = np.asarray(u)[1, :, ny // 2, nz // 2]
    xi = np.arange(nx) - 0.5
    exact = U * xi / (nx - 2)
    m = np.asarray(cc.fluid)[:, ny // 2, nz // 2]
    dev = np.abs((uy - exact)[m]).max() / U
    assert dev < 1e-4, f"Couette max deviation {dev:.2e} of U"


def _bb_cavity(n=16, **kw):
    return get_case("lid_driven_cavity", n=n, lid="bounceback", **kw)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(collision="trt"),
    dict(force=(1e-5, 0.0, 2e-5)),
])
def test_bb_lid_sparse_variant_matches_dense(kwargs):
    assert_sparse_matches_dense(_bb_cavity(**kwargs), nsteps=5)


def test_moving_walls_with_z_fixup_matches_dense():
    """Every WALL of the tiny coronary relabeled MOVING (a translating
    vessel wall): exercises the Ladd term in the pulls, the NEE plane
    fixups AND the z-plane outlets in one case, sparse against dense."""
    spec0 = get_case("coronary", shape=(24, 20, 32), radius=4)
    mask = np.where(np.asarray(spec0.mask) == int(CellType.WALL),
                    np.int32(int(CellType.MOVING)), spec0.mask)
    assert_sparse_matches_dense(dataclasses.replace(
        spec0, mask=mask, wall_velocity=(1e-3, 0.0, 0.0)))


def test_bb_lid_sparse_matches_dense():
    from lbm_jax.engine.sparse import (
        compile_sparse,
        initial_f_sparse,
        make_sparse_step,
        scatter_dense,
    )

    spec = get_case("lid_driven_cavity", n=16, lid="bounceback")
    sc = compile_sparse(spec)
    cc = compile_case(spec)
    sstep = jax.jit(make_sparse_step(sc))
    fs = initial_f_sparse(sc)
    for t in range(4):
        fs, _, _ = sstep(fs, jnp.int32(t))
    fd = np.asarray(scatter_dense(sc, fs))
    f_ref = _dense_run(cc, initial_f(cc), 4)
    live = np.asarray(sc.index) >= 0
    np.testing.assert_allclose(
        fd[:, live], f_ref[:, live], rtol=3e-6, atol=1e-7
    )


def test_bb_lid_converges_like_nee_lid():
    """Both lid treatments converge to the same cavity flow; at n=16
    they differ by the half-cell lid-position offset (measured rel L2
    0.25, corr 0.988 — shrinking ~1/n, see the slow resolution study)."""
    res = {}
    for lid in ("nee", "bounceback"):
        sim = Simulation(get_case("lid_driven_cavity", n=16, lid=lid,
                                  max_steps=6000, time_save=200))
        r = sim.run(verbose=False)
        assert r.converged
        rho, u = sim.macro()
        res[lid] = (np.asarray(u), np.asarray(sim.cc.fluid))
    u1, fl = res["nee"]
    u2, _ = res["bounceback"]
    corr = np.corrcoef(u1[:, fl].ravel(), u2[:, fl].ravel())[0, 1]
    assert corr > 0.98, f"NEE/BB lid correlation {corr:.4f}"
    d = np.linalg.norm((u1 - u2)[:, fl]) / np.linalg.norm(u1[:, fl])
    assert d < 0.35, f"NEE/BB lid rel L2 {d:.3f}"


@pytest.mark.slow
def test_bb_lid_difference_shrinks_with_resolution():
    """The NEE-vs-BB lid delta is a discretization artifact (half-cell
    lid position): first-order convergent. Measured 0.252 / 0.187 /
    0.148 at n = 16 / 24 / 32."""
    deltas = []
    for n in (16, 24):
        res = {}
        for lid in ("nee", "bounceback"):
            sim = Simulation(get_case("lid_driven_cavity", n=n, lid=lid,
                                      max_steps=9000, time_save=300))
            sim.run(verbose=False)
            rho, u = sim.macro()
            res[lid] = (np.asarray(u), np.asarray(sim.cc.fluid))
        u1, fl = res["nee"]
        u2, _ = res["bounceback"]
        deltas.append(np.linalg.norm((u1 - u2)[:, fl])
                      / np.linalg.norm(u1[:, fl]))
    assert deltas[1] < 0.85 * deltas[0], deltas
