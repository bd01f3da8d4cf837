"""Property tests for the D3Q19 lattice (SURVEY.md section 7 step 1)."""

import jax.numpy as jnp
import numpy as np

from lbm_jax.core.lattice import D3Q19, feq, moments, phi


def test_weights_normalized():
    assert np.isclose(D3Q19.W.sum(), 1.0)


def test_first_moment_of_weights_vanishes():
    assert np.all(D3Q19.E.T @ D3Q19.W == 0)


def test_second_moment_isotropy():
    # sum_i w_i e_ia e_ib = cs^2 delta_ab with cs^2 = 1/3
    s = np.einsum("i,ia,ib->ab", D3Q19.W, D3Q19.E, D3Q19.E)
    assert np.allclose(s, np.eye(3) / 3.0, atol=1e-7)


def test_opposite_pairs_involution():
    opp = D3Q19.OPP
    assert np.all(opp[opp] == np.arange(19))
    assert np.all(D3Q19.E[opp] == -D3Q19.E)


def test_dirs_into_match_reference_sets():
    # The hard-coded per-case direction sets (SURVEY.md section 0).
    assert sorted(D3Q19.dirs_into(1, -1)) == [4, 8, 10, 16, 18]  # lid/outlet -y
    assert sorted(D3Q19.dirs_into(1, +1)) == [3, 7, 9, 15, 17]   # inlet +y
    assert sorted(D3Q19.dirs_into(0, +1)) == [1, 7, 8, 11, 12]   # coronary inlet +x
    assert sorted(D3Q19.dirs_into(0, -1)) == [2, 9, 10, 13, 14]  # coronary outlet -x
    assert sorted(D3Q19.dirs_into(2, -1)) == [6, 12, 14, 17, 18] # sub-outlets -z


def test_feq_moments_roundtrip():
    rng = np.random.default_rng(0)
    rho = jnp.asarray(1.0 + 0.05 * rng.standard_normal((4, 5, 6)), jnp.float32)
    u = jnp.asarray(0.05 * rng.standard_normal((3, 4, 5, 6)), jnp.float32)
    f = feq(rho, u)
    rho2, u2 = moments(f)
    np.testing.assert_allclose(rho2, rho, rtol=2e-6)
    np.testing.assert_allclose(u2, u, atol=2e-6)


def test_feq_matches_reference_expansion():
    # Spot-check the vectorized feq against the hand-expanded per-direction
    # forms of ldc.cu:330-348 for a generic velocity.
    rho, (ux, uy, uz) = 1.07, (0.03, -0.02, 0.05)
    u = jnp.asarray([ux, uy, uz], jnp.float32).reshape(3, 1)
    f = np.asarray(feq(jnp.asarray([rho], jnp.float32), u))[:, 0]
    usq = ux * ux + uy * uy + uz * uz
    assert np.isclose(f[0], rho / 3 * (1 - 1.5 * usq), rtol=1e-6)
    assert np.isclose(
        f[1], rho / 18 * (1 + 3 * ux + 3 * ux * ux - 1.5 * uy * uy - 1.5 * uz * uz),
        rtol=1e-6,
    )
    assert np.isclose(
        f[7],
        rho / 36 * (1 + 3 * (ux + uy) + 3 * ux * ux + 3 * uy * uy
                    + 9 * ux * uy - 1.5 * uz * uz),
        rtol=1e-6,
    )
    assert np.isclose(
        f[16],
        rho / 36 * (1 + 3 * (uz - uy) + 3 * uy * uy + 3 * uz * uz
                    - 9 * uy * uz - 1.5 * ux * ux),
        rtol=1e-6,
    )


def test_phi_dirs_subset():
    u = jnp.asarray(np.full((3, 2), 0.01, np.float32))
    sub = phi(u, dirs=[4, 8])
    full = np.asarray(phi(u))
    np.testing.assert_allclose(sub, full[[4, 8]])
