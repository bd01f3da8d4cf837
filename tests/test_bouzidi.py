"""Bouzidi interpolated (curved-wall) bounce-back — core/bouzidi.py.

Beyond-reference: the reference runs half-way bounce-back on the voxel
staircase everywhere (its vessel geometries are voxelized surfaces);
Bouzidi linear interpolation restores second-order wall placement.
Anchors: exact degeneracy to half-way BB at q = 1/2, the analytic
Hagen-Poiseuille circular-pipe profile (the curved-wall measurement:
Bouzidi beats the staircase several-fold at the same resolution), and
dense/sparse/GSPMD cross-backend equivalence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.cases.pipe import pipe_sdf
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.runner import Simulation
from lbm_jax.engine.sparse import compile_sparse, initial_f_sparse, \
    make_sparse_step, scatter_dense
from lbm_jax.engine.step import initial_f, make_step


def _run_dense(spec, nsteps):
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return cc, np.asarray(f)


def test_q_half_degenerates_to_halfway_bb():
    """A planar SDF that puts every wall crossing exactly half-way must
    reproduce the plain staircase step bit-for-bit (the Bouzidi
    coefficients collapse to (1, 0, 0))."""
    n = 16
    spec = get_case("gravity_channel", n=n, nz=4)
    x = np.arange(n, dtype=np.float64)
    d = np.minimum(np.minimum(x - 1.5, n - 2.5 - x)[:, None],
                   np.minimum(x - 1.5, n - 2.5 - x)[None, :])
    sdf = np.repeat(d.astype(np.float32)[:, :, None], 4, axis=2)
    spec_bz = dataclasses.replace(spec, wall_sdf=sdf)
    _, f_plain = _run_dense(spec, 5)
    _, f_bz = _run_dense(spec_bz, 5)
    np.testing.assert_array_equal(f_bz, f_plain)


def _pipe_error(curved, n=36, radius=13.7, steps=4000, **kw):
    spec = get_case("pipe", n=n, nz=4, curved=curved, radius=radius, **kw)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=steps, tol=0.0, verbose=False)
    rho, u = sim.macro()
    uz = np.asarray(u[2][..., 2])
    c = ((n - 1) / 2 + 0.23, (n - 1) / 2 + 0.38)
    r2 = radius - pipe_sdf(n, radius, c)            # = r
    nu = (spec.tau - 0.5) / 3
    ua = spec.force[2] / (4 * nu) * (radius ** 2 - r2 ** 2)
    fl = np.asarray(spec.mask[..., 2]) == 4
    return float(np.sqrt(np.sum((uz[fl] - ua[fl]) ** 2)
                         / np.sum(ua[fl] ** 2)))


def test_pipe_bouzidi_beats_staircase():
    """Hagen-Poiseuille in an off-center circular pipe: measured (this
    config) 0.47% with Bouzidi vs 2.6% staircase — the second-order
    wall placement is the whole difference."""
    eb = _pipe_error(True)
    es = _pipe_error(False)
    assert eb < 0.008, f"bouzidi pipe error {eb:.4f}"
    assert eb < 0.35 * es, f"bouzidi {eb:.4f} vs staircase {es:.4f}"


@pytest.mark.slow
def test_pipe_resolution_scaling():
    """Halving the radius: the staircase error roughly doubles (first
    order) while the Bouzidi error grows faster than it (super-linear
    gap; measured 2.6x vs 2.15x — BGK's viscosity-dependent slip keeps
    linear-Bouzidi short of clean second order at this tau)."""
    eb_hi = _pipe_error(True, radius=13.7, steps=5000)
    eb_lo = _pipe_error(True, n=24, radius=6.85, steps=5000)
    es_hi = _pipe_error(False, radius=13.7, steps=5000)
    es_lo = _pipe_error(False, n=24, radius=6.85, steps=5000)
    assert eb_lo / eb_hi > 1.8
    assert eb_hi < 0.35 * es_hi
    assert eb_lo < 0.35 * es_lo


def test_pipe_sparse_matches_dense():
    spec = get_case("pipe", n=20, nz=4, radius=5.6)
    nsteps = 6
    cc, f_dense = _run_dense(spec, nsteps)
    sc = compile_sparse(spec)
    assert sc.link_q is not None
    step = jax.jit(make_sparse_step(sc))
    f = initial_f_sparse(sc)
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    f_scattered = np.asarray(scatter_dense(sc, jnp.asarray(f)))
    fluid = np.asarray(cc.fluid)
    np.testing.assert_allclose(
        f_scattered[:, fluid], f_dense[:, fluid], rtol=3e-6, atol=1e-7
    )


def test_pipe_gspmd_sharded_matches_dense():
    """Bouzidi's link arrays are plain per-direction fields, so the
    GSPMD partitioner shards them with the state."""
    from lbm_jax.parallel.mesh import lattice_mesh

    spec = get_case("pipe", n=24, nz=8, radius=6.6)
    sim1 = Simulation(spec, backend="xla")
    simN = Simulation(spec, backend="xla", mesh=lattice_mesh(),
                      shard_axis=2)
    sim1.run(max_steps=20, tol=0.0, verbose=False)
    simN.run(max_steps=20, tol=0.0, verbose=False)
    _, u1 = sim1.macro()
    _, uN = simN.macro()
    # atol at fp32 rho-scale reassociation noise (the partitioner's
    # collective-permuted rolls re-associate the moment sums)
    np.testing.assert_allclose(np.asarray(uN), np.asarray(u1),
                               rtol=3e-6, atol=3e-7)


def test_pipe_trt_composes():
    """Bouzidi operates on post-collision pdfs, so it is collision-
    agnostic: TRT + curved walls converges to the same analytic
    profile."""
    e = _pipe_error(True, steps=3000, collision="trt")
    assert np.isfinite(e) and e < 0.012


def test_pipe_wss_sdf_normals_beat_voxel_normals():
    """The analytic traction anchor: steady force-driven pipe has
    sigma_rz = F r / 2, so WSS at a wall-adjacent cell at radius r is
    F r / 2 exactly. With the SDF present, wall_normals uses the true
    -grad(sdf) surface normal instead of the w_i-weighted voxel
    estimate; measured here (n=36, R=13.7): max rel error 14.2% -> 1.7%
    and p90 7.4% -> 1.1% — the staircase NORMAL direction, not the
    stress tensor, dominates the curved-wall WSS tail."""
    from lbm_jax.engine.stress import wall_normals, wss_field

    n, radius = 36, 13.7
    spec = get_case("pipe", n=n, nz=4, curved=True, radius=radius)
    sim = Simulation(spec, backend="xla")
    sim.run(max_steps=4000, tol=0.0, verbose=False)
    cc, f = sim._dense_cc_f()
    c = ((n - 1) / 2 + 0.23, (n - 1) / 2 + 0.38)
    r3 = np.repeat((radius - pipe_sdf(n, radius, c))[:, :, None],
                   4, axis=2)
    exact = spec.force[2] * r3 / 2.0

    def rel_err(normals):
        w = np.asarray(wss_field(cc, f, sim.t, normals))
        sel = w != 0
        return np.abs(w[sel] - exact[sel]) / exact[sel]

    rv = rel_err(wall_normals(spec.mask))
    rs = rel_err(wall_normals(spec.mask, spec.wall_sdf))
    assert float(rs.max()) < 0.03, f"sdf-normal max err {rs.max():.4f}"
    assert float(np.percentile(rs, 90)) < 0.02
    assert float(rs.max()) < 0.3 * float(rv.max())
    assert float(np.median(rs)) < float(np.median(rv))
    # Simulation.wss() picks the SDF normals up automatically
    w_auto = np.asarray(sim.wss())
    w_sdf = np.asarray(wss_field(cc, f, sim.t,
                                 wall_normals(spec.mask, spec.wall_sdf)))
    np.testing.assert_array_equal(w_auto, w_sdf)


def test_coronary_curved_variant_sparse_matches_dense():
    """The flagship synthetic tree gains a Bouzidi variant
    (coronary curved=True): pipe-style mask around the exact
    union-of-cylinders SDF with the same BC topology (inlet / outlet /
    3 windowed sub-outlets). Dense and sparse agree with link_q
    active through the multi-BC fixup chain."""
    spec = get_case("coronary", shape=(48, 24, 40), radius=5,
                    curved=True)
    assert spec.wall_sdf is not None
    nsteps = 6
    cc, f_dense = _run_dense(spec, nsteps)
    assert cc.link_q is not None
    lq = np.asarray(cc.link_q)
    # real fractional distances, not the all-half-way degenerate case
    assert (np.abs(lq - 0.5) > 0.05).sum() > 100
    sc = compile_sparse(spec)
    step = jax.jit(make_sparse_step(sc))
    f = initial_f_sparse(sc)
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    f_scattered = np.asarray(scatter_dense(sc, jnp.asarray(f)))
    fluid = np.asarray(cc.fluid)
    np.testing.assert_allclose(
        f_scattered[:, fluid], f_dense[:, fluid], rtol=3e-6, atol=1e-7
    )


@pytest.mark.slow
def test_coronary_curved_wss_ring():
    """Physical anchor on the flagship tree: in the straight main-tube
    segment upstream of the first branch, the WSS ring must be
    circumferentially uniform (axisymmetric Poiseuille) and match the
    analytic tau_w = 4 rho nu u_mean / R from the measured flow rate.
    Measured (3000 steps, tau=0.8, shape 64x32x48, r=6): curved
    cv 0.070/0.111 vs voxel 0.128/0.147 at x=12/14, mean/pred 0.945
    (cell centers sit half a link inside the wall) vs voxel 1.09."""
    from lbm_jax.geometry.mask import CellType

    def ring_stats(curved):
        spec = get_case("coronary", shape=(64, 32, 48), radius=6,
                        curved=curved, tau=0.8, max_steps=10**9)
        sim = Simulation(spec, backend="xla")
        sim.run(max_steps=3000, tol=0.0, verbose=False)
        _, u = sim.macro()
        ux = np.asarray(u[0])
        w = np.asarray(sim.wss())
        m = np.asarray(spec.mask)
        nu = (0.8 - 0.5) / 3
        R = 6 - 0.28 if curved else 6
        out = []
        for xs in (12, 14):
            fl = m[xs] == CellType.FLUID
            pred = 4 * nu * ux[xs][fl].mean()
            ring = w[xs][w[xs] > 0]
            out.append((ring.mean() / (pred / R),
                        ring.std() / ring.mean()))
        return out

    sc = ring_stats(True)
    sv = ring_stats(False)
    for (mc, cvc), (mv, cvv) in zip(sc, sv):
        assert 0.85 < mc < 1.05, f"curved mean/pred {mc:.3f}"
        assert cvc < 0.8 * cvv, f"curved cv {cvc:.3f} vs voxel {cvv:.3f}"


def test_auto_backend_falls_back_to_xla():
    spec = get_case("pipe", n=20, nz=4, radius=5.6)
    sim = Simulation(spec, backend="auto")
    assert sim.backend in ("xla", "sparse")
