"""Stencil/engine isotropy property tests (SURVEY section 4: rotation
symmetry) — the whole fused step (streaming, bounce-back, NEE) must
commute with lattice rotations and reflections."""

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.core.units import UnitSystem
from lbm_jax.engine.compile import compile_case
from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.engine.step import initial_f, make_step
from lbm_jax.geometry.mask import CellType
from lbm_jax.geometry.shapes import cavity_mask


def _run_cavity(n, lid_axis, flow_axis, nsteps):
    """Cavity with the moving lid on plane `lid_axis` = n-2, dragging
    fluid along `flow_axis`."""
    mask = cavity_mask(n, n, n)
    # cavity_mask puts the lid at y = n-2; re-orient by transposition.
    perm = {1: lid_axis}
    rest = [a for a in range(3) if a != lid_axis]
    perm[0], perm[2] = rest[0], rest[1]
    inv = [0, 0, 0]
    for src, dst in perm.items():
        inv[dst] = src
    mask = np.transpose(mask, inv)

    u_max = 0.06
    u_val = [0.0, 0.0, 0.0]
    u_val[flow_axis] = u_max
    lid = PlaneBC(
        mask_value=int(CellType.INLET), axis=lid_axis, coord=n - 2,
        normal=-1, rho_mode="extrapolate", u_mode="fixed",
        u_value=tuple(u_val),
    )
    u0 = np.zeros((3, n, n, n), np.float32)
    sl = [slice(None)] * 3
    for c in (n - 1, n - 2):
        sl[lid_axis] = c
        u0[(flow_axis,) + tuple(sl)] = u_max
    spec = CaseSpec(
        name="sym", shape=(n, n, n), tau=0.55,
        units=UnitSystem(CH=1.0, C_U=1.0), mask=mask, boundaries=[lid],
        u0=u0,
    )
    cc = compile_case(spec)
    step = jax.jit(make_step(cc))
    f = initial_f(cc)
    for t in range(nsteps):
        f, rho, u = step(f, jnp.int32(t))
    return np.asarray(u), np.asarray(cc.fluid)


def test_rotation_symmetry_of_full_engine():
    """Lid on y dragging +z vs lid on z dragging +y: the flows must map
    onto each other under the y<->z transposition."""
    n, nsteps = 16, 40
    u_a, fluid_a = _run_cavity(n, lid_axis=1, flow_axis=2, nsteps=nsteps)
    u_b, fluid_b = _run_cavity(n, lid_axis=2, flow_axis=1, nsteps=nsteps)
    # Map B into A's frame: swap spatial y/z and velocity components y/z.
    u_b_mapped = u_b[[0, 2, 1]].transpose(0, 1, 3, 2)
    fluid_b_mapped = fluid_b.transpose(0, 2, 1)
    np.testing.assert_array_equal(fluid_a, fluid_b_mapped)
    np.testing.assert_allclose(
        u_a[:, fluid_a], u_b_mapped[:, fluid_a], rtol=1e-4, atol=1e-6
    )


def test_reflection_symmetry_of_cavity_flow():
    """The lid moves along +z; the geometry is symmetric in x, so u_x is
    antisymmetric and u_y/u_z symmetric under x -> -x."""
    n, nsteps = 16, 60
    u, fluid = _run_cavity(n, lid_axis=1, flow_axis=2, nsteps=nsteps)
    u_ref = u[:, ::-1, :, :].copy()
    u_ref[0] = -u_ref[0]
    fluid_ref = fluid[::-1, :, :]
    np.testing.assert_array_equal(fluid, fluid_ref)
    np.testing.assert_allclose(
        u[:, fluid], u_ref[:, fluid], rtol=1e-4, atol=1e-6
    )
