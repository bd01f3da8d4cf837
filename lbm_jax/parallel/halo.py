"""Explicit halo-exchange step via shard_map + lax.ppermute.

The manual-collective formulation of the spatial decomposition: each
device owns a contiguous slab along one lattice axis; per step it
exchanges one face plane with each ring neighbor over ICI — only the 5
populations that stream inward across that face (e_axis = +1 from the
left neighbour, e_axis = -1 from the right), not all 19: a 3.8x ICI
traffic cut over the naive full-plane exchange.

Functionally identical to letting GSPMD partition the jnp.roll step
(parallel/mesh.py); tests/test_parallel.py checks both against the
single-device engine bit-for-bit on the 8-device CPU mesh.

The sharded axis must carry no NEE boundary plane (see mesh.py); the
ring exchange reproduces jnp.roll's global wrap, whose wrapped-in values
only ever land on dead/ghost cells (or implement Poiseuille's intended
y-wrap, Poiseulle.cu:617).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lbm_jax.core.lattice import D3Q19, phi
from lbm_jax.engine.compile import CompiledCase
from lbm_jax.engine.step import (apply_bc_fixup, guo_source,
                                 half_force_shift, moving_bb_terms)

_E = D3Q19.E
_OPP = D3Q19.OPP
_EF = _E.astype(np.float32)


def inbound_dirs(lat_axis: int, sign: int) -> list[int]:
    """Populations streaming across a face: e[lat_axis] == sign (5 each)."""
    return [i for i in range(1, D3Q19.Q) if int(_E[i][lat_axis]) == sign]


def _exchange_halos(f, axis_name: str, lat_axis: int):
    """Return (lo, hi): lo = the left neighbor's last plane restricted to
    the 5 populations with e_axis = +1 (the only ones pulled across that
    face), hi = the right neighbor's first plane restricted to the 5 with
    e_axis = -1. Ring wrap matches jnp.roll semantics. Exchanging 5 of 19
    populations per face cuts ICI bytes 3.8x vs a full-plane exchange."""
    n = jax.lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    ax = 1 + lat_axis
    pos = jnp.asarray(inbound_dirs(lat_axis, +1))
    neg = jnp.asarray(inbound_dirs(lat_axis, -1))
    last = jax.lax.slice_in_dim(f, f.shape[ax] - 1, f.shape[ax], axis=ax)
    first = jax.lax.slice_in_dim(f, 0, 1, axis=ax)
    lo = jax.lax.ppermute(last[pos], axis_name, fwd)   # from left neighbor
    hi = jax.lax.ppermute(first[neg], axis_name, bwd)  # from right neighbor
    return lo, hi


def _pull_ext(f_i, halo_plane, e, lat_axis: int):
    """Pull-stream one direction: the sharded axis splices the received
    neighbor plane (when this direction crosses the face), local axes use
    rolls. halo_plane: the (1, ...)-shaped received plane for THIS
    direction, or None when e[lat_axis] == 0."""
    shifts = [int(s) for s in e]
    s_ax = shifts[lat_axis]
    ax = lat_axis
    if s_ax == 0:
        sliced = f_i
    elif s_ax > 0:  # pull from the left: halo plane enters at index 0
        body = jax.lax.slice_in_dim(f_i, 0, f_i.shape[ax] - 1, axis=ax)
        sliced = jnp.concatenate([halo_plane, body], axis=ax)
    else:  # pull from the right: halo plane enters at the end
        body = jax.lax.slice_in_dim(f_i, 1, f_i.shape[ax], axis=ax)
        sliced = jnp.concatenate([body, halo_plane], axis=ax)
    other = [a for a in range(3) if a != lat_axis]
    roll_axes = [a for a in other if shifts[a] != 0]
    if roll_axes:
        sliced = jnp.roll(
            sliced, shift=[shifts[a] for a in roll_axes], axis=roll_axes
        )
    return sliced


def make_halo_step(
    cc: CompiledCase, mesh: Mesh, shard_axis: int = 0, axis_name: str = "d"
) -> Callable:
    """Build a shard_map'd fused step over `mesh`, decomposed along
    `shard_axis`. Arrays must be sharded with PartitionSpec along that
    axis (see mesh.shard_case)."""
    assert cc.link_q is None, (
        "the explicit halo-exchange path does not thread Bouzidi link_q; "
        "use the GSPMD dense path (Simulation mesh=) for curved walls"
    )
    from lbm_jax.engine.step import has_windkessel
    assert not has_windkessel(cc.bcs), (
        "the explicit halo-exchange path does not thread the windkessel "
        "state (the outlet flux sum would need a psum); use the GSPMD "
        "dense path (Simulation mesh=) for RCR outlets"
    )
    import dataclasses

    inv_tau = 1.0 / cc.tau
    for bc in cc.bcs:
        if bc.axis == shard_axis:
            raise ValueError(
                f"BC on axis {bc.axis} conflicts with shard axis {shard_axis}"
            )

    # BC plane arrays are global lateral planes whose lateral axes include
    # the sharded lattice axis -> pass them through shard_map, sharded on
    # the matching lateral dim.
    def _bc_lat_dim(bc) -> int:
        lat = [a for a in range(3) if a != bc.axis]
        return lat.index(shard_axis)

    bc_arrays = []
    bc_specs = []
    for bc in cc.bcs:
        idx = _bc_lat_dim(bc)
        arrs, specs = {}, {}
        arrs["valid"] = bc.valid
        specs["valid"] = P(*(
            [None, axis_name, None] if idx == 0 else [None, None, axis_name]
        ))
        if bc.phi_star is not None:
            arrs["phi_star"] = bc.phi_star
            specs["phi_star"] = specs["valid"]
        if bc.phi_star_series is not None:
            arrs["phi_star_series"] = bc.phi_star_series
            specs["phi_star_series"] = P(*(
                [None, None, axis_name, None] if idx == 0
                else [None, None, None, axis_name]
            ))
        bc_arrays.append(arrs)
        bc_specs.append(specs)

    dirs_pos = inbound_dirs(shard_axis, +1)
    dirs_neg = inbound_dirs(shard_axis, -1)

    bb = (None if cc.wall_velocity is None
          else moving_bb_terms(cc.wall_velocity))

    def local_step(f, nbr_wall, nbr_moving, fluid, t, bc_data):
        lo, hi = _exchange_halos(f, axis_name, shard_axis)
        pulled = [f[0]]
        for i in range(1, D3Q19.Q):
            if i in dirs_pos:
                plane = lo[dirs_pos.index(i)]
            elif i in dirs_neg:
                plane = hi[dirs_neg.index(i)]
            else:
                plane = None
            direct = _pull_ext(f[i], plane, _E[i], shard_axis)
            v = jnp.where(nbr_wall[i], f[_OPP[i]], direct)
            if bb is not None:
                v = jnp.where(nbr_moving[i], f[_OPP[i]] + bb[i], v)
            pulled.append(v)
        pulled = jnp.stack(pulled)
        for bc, arrs in zip(cc.bcs, bc_data):
            pulled = apply_bc_fixup(pulled, f, dataclasses.replace(bc, **arrs), t,
                                    force=cc.force)
        rho = jnp.sum(pulled, axis=0)
        mom = jnp.tensordot(
            jnp.asarray(_EF.T), pulled, axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )
        mom = half_force_shift(mom, cc.force)
        u = mom / jnp.where(rho == 0, 1.0, rho)[None]
        f_eq = rho[None] * phi(u)
        if cc.closure is not None:
            from lbm_jax.core.rheology import tau_eff
            fneq = pulled - f_eq
            te = tau_eff(fneq, rho, cc.tau, cc.closure)
            f_post = pulled - fneq / te[None]
            if cc.force is not None:
                f_post = f_post + guo_source(u, cc.force, cc.tau,
                                             tau_local=te)
            f_new = jnp.where(fluid[None], f_post, f)
            return f_new, rho, u
        if cc.mrt_k is not None:
            fneq = pulled - f_eq
            f_post = pulled - jnp.tensordot(
                jnp.asarray(cc.mrt_k), fneq, axes=([1], [0]),
                precision=jax.lax.Precision.HIGHEST)
        elif cc.tau_minus is None:
            f_post = pulled - (pulled - f_eq) * inv_tau
        else:  # TRT parity split (engine/step.collide semantics)
            opp = jnp.asarray(D3Q19.OPP)
            hp = np.float32(0.5 * inv_tau)
            hm = np.float32(0.5 / cc.tau_minus)
            f_post = (pulled
                      - ((pulled + pulled[opp]) - (f_eq + f_eq[opp])) * hp
                      - ((pulled - pulled[opp]) - (f_eq - f_eq[opp])) * hm)
        if cc.force is not None:
            f_post = f_post + guo_source(u, cc.force, cc.tau,
                                         cc.tau_minus, cc.mrt_kf)
        f_new = jnp.where(fluid[None], f_post, f)
        return f_new, rho, u

    def sspec(leading):
        s = [None] * (leading + 3)
        s[leading + shard_axis] = axis_name
        return P(*s)

    fspec = sspec(1)
    shard_step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(fspec, fspec, fspec, sspec(0), P(), bc_specs),
        out_specs=(fspec, sspec(0), sspec(1)),
    )
    # nbr_moving is None for ordinary cases; shard_map needs a real
    # array operand, so reuse nbr_wall as an ignored stand-in then.
    nbr_moving = cc.nbr_moving if cc.nbr_moving is not None else cc.nbr_wall

    def step(f, t):
        return shard_step(f, cc.nbr_wall, nbr_moving, cc.fluid, t,
                          bc_arrays)

    return step


__all__ = ["make_halo_step"]
