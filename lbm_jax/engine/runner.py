"""Host-side simulation driver: jitted scan chunks, convergence policy,
output cadence, checkpointing, throughput metering.

Replaces the reference's per-case main() loops (ldc.cu:612-717,
bifurcation.cu:1177-1283) with one engine:
  - the hot loop is a jax.lax.scan over `time_save` fused steps, jitted
    once and re-invoked per chunk (device round-trips only at the save
    cadence, like the reference's D->H copies every time_save);
  - convergence flavor 'velsum': per-step residual
    |s_k - s_{k-1}| / s_k with s = sum |u|, stop after `stag_max`
    sub-tolerance steps (ldc.cu:653-685);
  - flavor 'usq': windowed residual between consecutive snapshots of
    sum u^2 over interior fluid cells (bifurcation.cu:1158-1175,
    :1258-1273), fixed step count;
  - MLUPS metering (thesis section 4.9.1 reports MLUPS).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from lbm_jax.device import resolve_backend
from lbm_jax.engine.compile import CompiledCase, compile_case
from lbm_jax.engine.spec import CaseSpec
from lbm_jax.engine.step import initial_f, macro_fields, make_step


@dataclasses.dataclass
class RunResult:
    """mlups follows the reference's NLATTICE convention — site count =
    non-DEAD cells, the number every solver prints next to "#LATTICE"
    (sparse solvers compact to exactly these sites, Poiseulle.cu:940-1050;
    for the dense lid cavity the whole box is non-dead so it coincides
    with ldc.cu:54,689). The other two conventions are reported
    explicitly: mlups_live counts fluid cells only (physics throughput),
    mlups_box the full padded box (raw-grid throughput, bench.py's
    number for the dense cavity)."""

    steps: int
    residual: float
    residual_history: list
    elapsed_s: float
    mlups: float
    converged: bool
    mlups_live: float = 0.0
    mlups_box: float = 0.0


def _interior_region(shape):
    nx, ny, nz = shape
    return (slice(1, nx - 1), slice(2, ny - 2), slice(1, nz - 1))


class Simulation:
    """One engine for all cases and both step backends.

    backend:
      'xla'    — the dense jnp step over the whole box (engine/step.py);
                 with mesh= the state is decomposed by GSPMD along a
                 BC-free lattice axis (shard_axis, default free_axis)
      'sparse' — gather/scatter over live cells only (engine/sparse.py);
                 single-device
      'auto'   — 'xla' (device.resolve_backend)
    """

    def __init__(
        self,
        case: CaseSpec | CompiledCase,
        donate: bool = True,
        backend: str = "auto",
        mesh=None,
        shard_axis: int | None = None,
    ):
        spec = case.spec if isinstance(case, CompiledCase) else case
        backend = resolve_backend(backend)
        if mesh is not None and shard_axis is None:
            from lbm_jax.parallel.mesh import free_axis

            shard_axis = free_axis(spec)
        sharding = None
        if backend == "sparse":
            if mesh is not None:
                raise ValueError(
                    "backend='sparse' is single-device: the gather/scatter "
                    "index space has no spatial shard decomposition. Use "
                    "backend='xla' with mesh= (GSPMD) for multi-device "
                    "runs."
                )
            from lbm_jax.engine.sparse import compile_sparse

            self.sc = compile_sparse(spec)
            self.cc = None
        else:
            self.sc = None
            self.cc = (
                case if isinstance(case, CompiledCase) else compile_case(case)
            )
            if mesh is not None:
                # mesh= on the dense backend means GSPMD decomposition:
                # shard the state and the case's per-cell arrays along the
                # BC-free axis; jit's SPMD partitioner turns the rolls into
                # halo collective-permutes.
                from lbm_jax.parallel.mesh import lattice_sharding, shard_case

                sharding = lattice_sharding(
                    axis=shard_axis, mesh=mesh, leading=1
                )
                self.cc = shard_case(self.cc, mesh, shard_axis)
        self.backend = backend
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.spec = spec
        self.sharding = sharding
        self._chunk_fns: dict[int, Callable] = {}
        self._usq_fn = None
        self._donate = donate
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self):
        if self.backend == "sparse":
            from lbm_jax.engine.sparse import initial_f_sparse

            f = initial_f_sparse(self.sc)
        else:
            f = initial_f(self.cc)
            if self.sharding is not None:
                f = jax.device_put(f, self.sharding)
        self.f = f
        self.t = 0
        # Windkessel per-outlet P_c carry (spec.PlaneBC.windkessel;
        # order = windkessel BCs within spec.boundaries).
        p0 = [b.windkessel_p0 for b in self.spec.boundaries
              if b.windkessel is not None]
        self.wk = jnp.asarray(p0, jnp.float32) if p0 else None
        self._last_velsum: Optional[float] = None
        self._last_usq: Optional[float] = None

    def f_standard(self):
        """f in the portable unpadded (19, nx, ny, nz) layout (dead cells
        hold zeros on the sparse backend)."""
        if self.backend == "sparse":
            from lbm_jax.engine.sparse import scatter_dense

            return scatter_dense(self.sc, self.f)
        return self.f

    def set_f_standard(self, f):
        if self.backend == "sparse":
            mask = np.asarray(self.spec.mask)
            live = np.argwhere(mask != 0)
            order = np.lexsort((live[:, 0], live[:, 1], live[:, 2]))
            live = live[order]
            self.f = jnp.asarray(f)[:, live[:, 0], live[:, 1], live[:, 2]]
            return
        self.f = jnp.asarray(f)
        if self.sharding is not None:
            self.f = jax.device_put(self.f, self.sharding)

    def macro(self):
        """(rho, u) persistent macroscopic fields (lattice units), in the
        unpadded layout."""
        if self.backend == "sparse":
            from lbm_jax.engine.sparse import (
                macro_fields_sparse,
                scatter_dense,
            )

            rho, u = macro_fields_sparse(self.sc, self.f)
            return (
                scatter_dense(self.sc, rho, fill=1.0),
                scatter_dense(self.sc, u),
            )
        return macro_fields(self.cc, self.f)

    def stress(self):
        """(sigma6, rho, u) deviatoric-stress diagnostics of the current
        state (engine/stress.stress_fields; lattice units, unpadded
        layout). Evaluates on a dense pre-collision pull: on the sparse
        backend the state round-trips through f_standard() plus a cached
        dense compile of the spec — an output-rate operation (like VTK),
        not a hot-loop one. Dense memory: ~5 full (19,X,Y,Z) arrays;
        wss() on the sparse backend stays O(live cells)
        (engine/stress.stress_fields_sparse)."""
        from lbm_jax.engine.stress import stress_fields

        cc, f = self._dense_cc_f()
        return stress_fields(cc, f, self.t, wk=self.wk)

    def _sparse_cc_f(self):
        """(SparseCase, compacted (19, n_live) f) of the sparse backend,
        for O(live-cell) stress diagnostics."""
        assert self.backend == "sparse"
        return self.sc, self.f

    def _normals(self):
        """Cached wall normals for WSS (engine/stress.wall_normals),
        compacted to live cells on the sparse backend."""
        if getattr(self, "_wss_normals", None) is None:
            from lbm_jax.engine.stress import compact_normals, wall_normals

            n = wall_normals(self.spec.mask, self.spec.wall_sdf)
            self._wss_normals = (compact_normals(self.sc, n)
                                 if self.backend == "sparse" else n)
        return self._wss_normals

    def wss(self):
        """(X, Y, Z) wall shear stress magnitude (lattice units;
        * units.C_pre for Pa), nonzero at wall-adjacent fluid cells
        (engine/stress.wss_field). The sparse backend evaluates the
        compacted stress and only this single output field goes
        dense."""
        if self.backend == "sparse":
            from lbm_jax.engine.sparse import scatter_dense
            from lbm_jax.engine.stress import wss_sparse

            return scatter_dense(self.sc, wss_sparse(
                self.sc, self.f, self.t, self._normals(), wk=self.wk))
        from lbm_jax.engine.stress import wss_field

        cc, f = self._dense_cc_f()
        return wss_field(cc, f, self.t, self._normals(), wk=self.wk)

    def wss_accumulator(self):
        """A WSSAccumulator (TAWSS/OSI over a pulsatile window) bound
        to this simulation's case; call acc.sample_sim(self) at each
        sampling time (engine/stress.WSSAccumulator). On the sparse
        backend it works in the compacted layout; there tawss()/osi()
        come back (n_live,) — scatter with
        engine/sparse.scatter_dense(sim._sparse_cc_f()[0], ...)."""
        from lbm_jax.engine.stress import (SparseWSSAccumulator,
                                           WSSAccumulator)

        if self.backend == "sparse":
            return SparseWSSAccumulator(self.sc, self._normals())
        return WSSAccumulator(self._dense_cc_f()[0], self._normals())

    def _dense_cc_f(self):
        """(dense unpadded CompiledCase, dense unpadded f) for the
        stress diagnostics, whatever the run backend."""
        if self.backend == "xla":
            return self.cc, self.f
        if getattr(self, "_stress_cc", None) is None:
            self._stress_cc = compile_case(self.spec)
        return self._stress_cc, jnp.asarray(self.f_standard())

    # -- jitted chunk -----------------------------------------------------
    def _chunk(self, n: int) -> Callable:
        """Jitted n-step chunk: (f, t[, wk]) -> (f', t', velsum series
        (n,)[, wk']). The compiled case (a pytree, compile.register_case)
        is a jit ARGUMENT bound here, so the program holds no per-cell
        constants."""
        if n not in self._chunk_fns:
            sparse = self.backend == "sparse"
            has_wk = self.wk is not None
            if sparse:
                from lbm_jax.engine.sparse import (make_sparse_step,
                                                   make_sparse_step_wk)

                make = make_sparse_step_wk if has_wk else make_sparse_step
            else:
                from lbm_jax.engine.step import make_step_wk

                make = make_step_wk if has_wk else make_step

            def run(case, f, t, *wk):
                step = make(case)
                offset = jnp.float32(case.velsum_offset)
                fluid = case.fluid

                def body(carry, _):
                    f, t, *wk = carry
                    f, rho, u, *wk = step(f, t, *wk)
                    speed = jnp.sqrt(jnp.sum(u * u, axis=0))
                    s = jnp.sum(jnp.where(fluid, speed, 0.0)) + offset
                    return (f, t + 1, *wk), s

                # unroll=2 lets the two alternating carry buffers of f
                # stay in place across the unrolled pair of steps
                (f, t, *wk), s = jax.lax.scan(
                    body, (f, t, *wk), xs=None, length=n,
                    unroll=2 if n % 2 == 0 else 1,
                )
                return (f, t, s, *wk)

            jitted = jax.jit(run,
                             donate_argnums=(1,) if self._donate else ())
            self._chunk_fns[n] = functools.partial(
                jitted, self.sc if sparse else self.cc)
        return self._chunk_fns[n]

    def _usq(self):
        """Windowed u^2 sum over the unpadded interior region, from the
        (rho, u) fields that macro() returns."""
        if self._usq_fn is None:
            spec = self.spec
            region = _interior_region(spec.shape)
            mask_r = np.asarray(spec.mask)[region]
            fluid_r = jnp.asarray(mask_r == 4)
            # bifurcation.cu:1167 sums labels >= 4 (sub-outlets included,
            # holding static init u), coronary.cu:1022 label == 4 only.
            if spec.usq_includes_outlet_labels:
                extra = mask_r > 4
                u0_r = np.asarray(spec.u0)[(slice(None),) + region]
                offset = float(
                    np.sum(np.sum(u0_r**2, axis=0)[extra], dtype=np.float64)
                )
            else:
                offset = 0.0

            def usq(u):
                usq_f = jnp.sum(u[(slice(None),) + region] ** 2, axis=0)
                return jnp.sum(jnp.where(fluid_r, usq_f, 0.0)) + offset

            self._usq_fn = jax.jit(usq)
        return self._usq_fn

    # -- main loop ----------------------------------------------------------
    def run(
        self,
        max_steps: Optional[int] = None,
        time_save: Optional[int] = None,
        tol: Optional[float] = None,
        stag_max: Optional[int] = None,
        on_save: Optional[Callable] = None,
        verbose: bool = True,
    ) -> RunResult:
        spec = self.spec
        max_steps = spec.max_steps if max_steps is None else max_steps
        time_save = spec.time_save if time_save is None else time_save
        tol = spec.tol if tol is None else tol
        stag_max = spec.stag_max if stag_max is None else stag_max
        flavor = spec.residual_flavor

        t_start = time.perf_counter()
        tol_count = 0
        residual = float("inf")
        history: list[float] = []
        converged = False
        steps_done_at_start = self.t
        n_fluid = int(
            np.asarray((self.sc if self.cc is None else self.cc).fluid).sum()
        )

        while self.t < steps_done_at_start + max_steps:
            n = min(time_save, steps_done_at_start + max_steps - self.t)
            if self.wk is not None:
                self.f, t_dev, s_series, self.wk = self._chunk(n)(
                    self.f, jnp.int32(self.t), self.wk)
            else:
                self.f, t_dev, s_series = self._chunk(n)(
                    self.f, jnp.int32(self.t))
            self.t += n
            s_series = np.asarray(s_series, np.float64)

            if flavor == "velsum":
                prev = self._last_velsum
                for s in s_series:
                    if prev is not None and s != 0:
                        r = abs(s - prev) / s
                        if r <= tol:
                            tol_count += 1
                        residual = r
                    prev = float(s)
                self._last_velsum = prev
            else:  # 'usq'
                s = float(self._usq()(self.macro()[1]))
                if self._last_usq is not None and s != 0:
                    residual = abs(self._last_usq - s) / s
                self._last_usq = s

            history.append(residual)
            elapsed = time.perf_counter() - t_start
            if verbose:
                print(
                    f"ITERATION # {self.t}, collapse time: "
                    f"{elapsed*1e3:.1f} ms, residual: {residual:.3e}"
                )
            if on_save is not None:
                on_save(self, self.t, residual)
            if flavor == "velsum" and tol_count > stag_max:
                converged = True
                break

        elapsed = time.perf_counter() - t_start
        steps = self.t - steps_done_at_start
        rate = steps / max(elapsed, 1e-12) / 1e6
        n_lattice = int((np.asarray(self.spec.mask) != 0).sum())
        return RunResult(
            steps=steps,
            residual=residual,
            residual_history=history,
            elapsed_s=elapsed,
            mlups=n_lattice * rate,
            converged=converged,
            mlups_live=n_fluid * rate,
            mlups_box=int(np.prod(self.spec.shape)) * rate,
        )


__all__ = ["Simulation", "RunResult"]
