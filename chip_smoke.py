"""Proof that the solver's main path runs on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases 0-5 below
    python chip_smoke.py --four     # four GPUs: the sharded flagship only

Everything runs in this one process (the CLI is called in-process), so
one process holds the card. With no GPU it exits nonzero before any
phase and prints no result line. Every phase raises on a failed check;
nothing is caught. The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases:
  0 device      — device kind and count, JAX version, XLA_FLAGS, the
                  compile cache, the card's name and power limit
  1 compile     — lower and compile the dense 256^3 cavity chunk and the
                  dense and sparse chunks of the flagship coronary tree
                  (291x291x372, pulsatile inlet, 4 RCR outlets, Carreau
                  blood); compile seconds and memory_analysis()
  2 parity      — (a) dense on the card vs the same step on the CPU, 64^3
                  cavity, 100 steps; (b) sparse vs dense on the card, the
                  flagship tree, 1000 steps, live cells and windkessel
                  state; (c) MRT on the card vs the CPU, with a control:
                  the MRT product K @ f_neq at HIGHEST and at the card's
                  DEFAULT matmul precision against a float64 product;
                  (d) the committed golden field
  3 main path   — lbm_jax.cli.main(["run", ...]) on the flagship tree and
                  the 256^3 cavity; outputs checked; steady ms/step and
                  MLUPS (box and live cells) of the dense and sparse steps
  4 clinical    — cli "transport --coupled" on the flagship tree and
                  "thermal --thermal-case cavity3d --n 128"
  5 copy floor  — the dense 256^3 step against a device copy that reads
                  and writes the same f, median and quartiles over
                  windows; a short profiler trace and its top device ops
  6 --four      — the flagship tree (pulsatile inlet, Newtonian) sharded
                  along y over four GPUs through GSPMD (Simulation mesh=,
                  4 RCR outlets) and the shard_map halo step (prescribed
                  outlets), each against the one-GPU dense result
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# Relative L2 bound for every parity check: fp32 throughout with the
# moment contractions pinned to HIGHEST precision, so two runs of the
# same scheme differ only in the order of sums (~1e-7 per step). Phase
# 2's precision control prints what the MRT product gives at the GPU's
# default float32 dot precision (TF32) for comparison.
PARITY_TOL = 1e-5

# RCR terminations (lattice units) of tools/demo_blood_wss.py
# --windkessel: main outlet, then the three sub-outlets.
WINDKESSEL = [[2e-4, 2e4, 1e-3]] + [[2e-4, 2e4, 3e-3]] * 3


@dataclasses.dataclass(frozen=True)
class Sizes:
    cavity_n: int = 256
    parity_n: int = 64
    parity_steps: int = 100
    tree_shape: tuple = (291, 291, 372)
    radius: int = 10
    pulsatile: tuple = (40, 1200)   # (phases, period in steps)
    # windkessel P_c is at rounding level until the pressure wave from
    # the inlet has reached the outlets (~500 steps across the flagship
    # box), so the runs compared on P_c go well past that
    sparse_steps: int = 1000
    cli_steps: int = 300
    time_save: int = 100
    transport_steps: int = 200
    thermal_n: int = 128
    thermal_steps: int = 500
    thermal_chunks: int = 2
    floor_steps: int = 50
    floor_windows: int = 7
    trace_steps: int = 10
    # y padded from 291 to 292 with one dead plane so it splits over 4
    four_shape: tuple = (291, 292, 372)
    four_steps: int = 500


FULL = Sizes()
# every phase at test sizes (tests/test_chip_smoke.py)
TINY = Sizes(cavity_n=16, parity_n=12, parity_steps=10,
             tree_shape=(48, 24, 40), radius=5, pulsatile=(4, 8),
             sparse_steps=200, cli_steps=20, time_save=10,
             transport_steps=10, thermal_n=12, thermal_steps=10,
             thermal_chunks=2, floor_steps=4, floor_windows=3,
             trace_steps=2, four_shape=(48, 24, 40), four_steps=100)


def card_label() -> str:
    """name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def rel_l2(a, b) -> float:
    import jax.numpy as jnp

    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


def check_parity(name: str, err: float, tol: float = PARITY_TOL) -> None:
    print(f"  parity {name}: rel L2 {err:.3e} (bound {tol:g})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: rel L2 {err:.3e} > {tol:g}")


def quartiles(xs):
    import numpy as np

    q1, q2, q3 = np.percentile(np.asarray(xs, np.float64), [25, 50, 75])
    return q1, q2, q3


def timed_windows(fn, windows: int):
    """Wall seconds of `windows` calls of fn(), each ending in
    block_until_ready; fn is already compiled."""
    import jax

    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def advance(sim, n: int):
    """One n-step chunk of the runner's own jitted scan, carried the way
    Simulation.run carries it (donated f, t, windkessel state), without
    run()'s host-side residual bookkeeping. Returns the velocity-sum
    series (on device)."""
    import jax.numpy as jnp

    out = sim._chunk(n)(sim.f, jnp.int32(sim.t),
                        *(() if sim.wk is None else (sim.wk,)))
    sim.f, s = out[0], out[2]
    if sim.wk is not None:
        sim.wk = out[3]
    sim.t += n
    return s


class Smoke:
    def __init__(self, sizes: Sizes, card: str, out: str):
        self.sizes = sizes
        self.card = card
        self.out = out
        self._tree = None
        self._sims = {}

    # -- configurations ---------------------------------------------------
    def clinical_opts(self, shape=None) -> dict:
        """The flagship clinical composition (the configuration
        tools/demo_blood_wss.py --windkessel builds, with the pulsatile
        series inlet): JSON-able case options for get_case and the CLI."""
        from lbm_jax.cases.coronary import C_U, CH
        from lbm_jax.core.rheology import carreau_blood
        from lbm_jax.core.units import UnitSystem

        s = self.sizes
        units = UnitSystem(CH=CH, C_U=C_U, C_rho=1060.0)
        return {"shape": list(shape or s.tree_shape), "radius": s.radius,
                "pulsatile": list(s.pulsatile), "windkessel": WINDKESSEL,
                "rheology": carreau_blood(units)}

    def tree(self):
        if self._tree is None:
            from lbm_jax.cases import get_case

            t0 = time.perf_counter()
            self._tree = get_case("coronary", **self.clinical_opts())
            print(f"  flagship tree {self._tree.shape}: geometry built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        return self._tree

    def sim(self, key: str):
        """Cached Simulations: 'tree-xla', 'tree-sparse', 'cavity'."""
        if key not in self._sims:
            from lbm_jax.cases import get_case
            from lbm_jax.engine.runner import Simulation

            t0 = time.perf_counter()
            if key == "cavity":
                spec = get_case("lid_driven_cavity", n=self.sizes.cavity_n)
                sim = Simulation(spec)
            else:
                sim = Simulation(self.tree(), backend=key.split("-")[1])
            print(f"  {key}: Simulation built in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            self._sims[key] = sim
        return self._sims[key]

    @staticmethod
    def chunk_args(sim, n: int):
        """(jitted chunk, its full argument tuple) for n steps."""
        import jax.numpy as jnp

        part = sim._chunk(n)
        args = part.args + (sim.f, jnp.int32(sim.t))
        if sim.wk is not None:
            args = args + (sim.wk,)
        return part.func, args

    # -- phases -----------------------------------------------------------
    def phase_compile(self) -> None:
        print("== phase 1: compile at real size", flush=True)
        for key in ("cavity", "tree-xla", "tree-sparse"):
            sim = self.sim(key)
            fn, args = self.chunk_args(sim, self.sizes.time_save)
            t0 = time.perf_counter()
            compiled = fn.lower(*args).compile()
            dt = time.perf_counter() - t0
            print(f"  {key} {sim.spec.shape} {self.sizes.time_save}-step "
                  f"chunk: compile {dt:.1f} s; memory_analysis: "
                  f"{compiled.memory_analysis()} [{self.card}]", flush=True)

    def _dense_on(self, device, spec, steps):
        import jax
        import numpy as np

        from lbm_jax.engine.runner import Simulation

        with jax.default_device(device):
            sim = Simulation(spec)
            sim.run(max_steps=steps, time_save=steps, verbose=False)
            return np.asarray(sim.f)

    def phase_parity(self) -> None:
        import dataclasses as dc

        import jax
        import jax.numpy as jnp
        import numpy as np

        from lbm_jax.cases import get_case

        print("== phase 2: parity against the plain reference", flush=True)
        s = self.sizes
        dev, cpu = jax.devices()[0], jax.devices("cpu")[0]
        cav = get_case("lid_driven_cavity", n=s.parity_n)
        mrt = dc.replace(cav, collision="mrt")
        for name, spec in (("(a) dense BGK", cav), ("(c) MRT", mrt)):
            f_dev = self._dense_on(dev, spec, s.parity_steps)
            f_cpu = self._dense_on(cpu, spec, s.parity_steps)
            check_parity(f"{name} {s.parity_n}^3 x{s.parity_steps} steps, "
                         f"{dev.platform} vs cpu", rel_l2(f_dev, f_cpu))
        self._precision_control(mrt, f_dev)

        dense, sparse = self.sim("tree-xla"), self.sim("tree-sparse")
        for sim in (dense, sparse):
            sim.run(max_steps=s.sparse_steps, time_save=s.time_save,
                    verbose=False)
        live = jnp.asarray(np.asarray(self.tree().mask) != 0)
        fd = jnp.where(live[None], dense.f, 0.0)
        fs = jnp.where(live[None], sparse.f_standard(), 0.0)
        check_parity(f"(b) sparse vs dense, flagship tree x{s.sparse_steps}"
                     " steps, live cells", rel_l2(fs, fd))
        check_parity("(b) windkessel P_c", rel_l2(sparse.wk, dense.wk))

        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.step import macro_fields

        golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "data", "golden_lid16_100.npz")
        spec16 = get_case("lid_driven_cavity", n=16)
        rho, u = macro_fields(compile_case(spec16),
                              jnp.asarray(self._dense_on(dev, spec16, 100)))
        with np.load(golden) as g:
            # the golden test's own bounds (tests/test_regression.py)
            np.testing.assert_allclose(np.asarray(u), g["u"], rtol=2e-4,
                                       atol=1.5e-6)
            np.testing.assert_allclose(np.asarray(rho), g["rho"],
                                       rtol=1e-5)
            err = rel_l2(u, g["u"])
        print(f"  parity (d) golden lid16 x100 on {dev.platform}: u rel L2 "
              f"{err:.3e} (within tests/test_regression.py bounds)",
              flush=True)

    def _precision_control(self, spec, f) -> None:
        """What the pinned precision guards against: the MRT product
        K @ f_neq of a state on the device, at HIGHEST (what the step
        uses; checked against the bound) and at DEFAULT precision (a
        GPU's float32 dot may then run in TF32; printed, not checked),
        each against the same product in float64 on the host."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        from lbm_jax.core.lattice import phi
        from lbm_jax.engine.compile import compile_case, mrt_of
        from lbm_jax.engine.step import macro_fields

        k, _ = mrt_of(spec)
        f = jnp.asarray(f)
        rho, u = macro_fields(compile_case(spec), f)
        fneq = f - rho[None] * phi(u)
        ref = np.tensordot(k.astype(np.float64),
                           np.asarray(fneq, np.float64), axes=([1], [0]))
        for prec in (jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT):
            prod = jax.jit(lambda a, b, p=prec: jnp.tensordot(
                a, b, axes=([1], [0]), precision=p))
            err = rel_l2(prod(jnp.asarray(k), fneq), ref)
            name = (f"(c) control: MRT K @ f_neq at {prec.name} vs float64 "
                    f"on {jax.devices()[0].platform}")
            if prec == jax.lax.Precision.HIGHEST:
                check_parity(name, err)
            else:
                print(f"  parity {name}: rel L2 {err:.3e} ("
                      f"{'above' if err > PARITY_TOL else 'within'} the "
                      f"bound {PARITY_TOL:g}; not checked) [{self.card}]",
                      flush=True)

    def _cli(self, argv):
        """lbm_jax.cli.main(argv) in this process; (stdout, seconds)."""
        from lbm_jax import cli

        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        dt = time.perf_counter() - t0
        text = buf.getvalue()
        print("\n".join("    | " + ln for ln in text.splitlines()[-6:]),
              flush=True)
        if rc != 0:
            raise RuntimeError(f"cli {argv[:3]} returned {rc}")
        return text, dt

    @staticmethod
    def _opt_args(opts: dict) -> list:
        return ["--opt"] + [f"{k}={json.dumps(v)}" for k, v in opts.items()]

    def _steady(self, key: str, n_cells_box: int, n_live: int) -> None:
        import jax
        import numpy as np

        sim = self.sim(key)
        n = self.sizes.time_save
        jax.block_until_ready(advance(sim, n))   # compiled in phase 1
        times = timed_windows(lambda: advance(sim, n), 3)
        q1, med, q3 = quartiles([t / n * 1e3 for t in times])
        if not np.isfinite(np.asarray(sim.macro()[1])).all():
            raise AssertionError(f"{key}: non-finite velocity field")
        print(f"  {key} steady: {med:.3f} ms/step (q1 {q1:.3f}, q3 "
              f"{q3:.3f}), {n_cells_box / med / 1e3:.1f} MLUPS box, "
              f"{n_live / med / 1e3:.1f} MLUPS live [{self.card}]",
              flush=True)

    def phase_main_path(self) -> None:
        import numpy as np

        from lbm_jax.geometry.mask import CellType

        print("== phase 3: main path through lbm_jax.cli.main", flush=True)
        s = self.sizes
        with tempfile.TemporaryDirectory() as d:
            tree_out = os.path.join(d, "tree")
            text, dt = self._cli(
                ["run", "--case", "coronary", "--out", tree_out,
                 "--steps", str(s.cli_steps), "--time-save",
                 str(s.time_save), "--vtk-final", "--binary-vtk"]
                + self._opt_args(self.clinical_opts()))
            self._check_run_outputs(tree_out, "coronary", s.cli_steps, text)
            print(f"  cli run coronary {s.tree_shape}: {s.cli_steps} steps "
                  f"in {dt:.1f} s wall incl. geometry, compile and VTK "
                  f"[{self.card}]", flush=True)
            cav_out = os.path.join(d, "cavity")
            text, dt = self._cli(
                ["run", "--case", "lid_driven_cavity", "--out", cav_out,
                 "--steps", str(s.cli_steps), "--time-save",
                 str(s.time_save), "--vtk-final", "--binary-vtk",
                 "--opt", f"n={s.cavity_n}"])
            self._check_run_outputs(cav_out, "lid_driven_cavity",
                                    s.cli_steps, text)
            print(f"  cli run cavity {s.cavity_n}^3: {s.cli_steps} steps in "
                  f"{dt:.1f} s wall incl. compile and VTK [{self.card}]",
                  flush=True)
        mask = np.asarray(self.tree().mask)
        box = int(mask.size)
        fluid = int((mask == CellType.FLUID).sum())
        print(f"  flagship tree: {box} box cells, {fluid} fluid "
              f"({fluid / box:.2%})", flush=True)
        for key in ("tree-xla", "tree-sparse"):
            self._steady(key, box, fluid)
        self._steady("cavity", s.cavity_n ** 3, s.cavity_n ** 3)

    @staticmethod
    def _check_run_outputs(out: str, name: str, steps: int, text: str):
        import math

        vtk = os.path.join(out, f"{name}_{steps}.vtk")
        for p in (vtk, os.path.join(out, "CONVERGENCE.log")):
            if not os.path.getsize(p) > 0:
                raise AssertionError(f"missing output {p}")
        res = [ln for ln in text.splitlines() if ln.startswith("Residual")]
        if not (res and math.isfinite(float(res[-1].split()[-1]))):
            raise AssertionError(f"{name}: no finite residual in {res}")
        for ln in text.splitlines():
            if ln.startswith("Windkessel P_c"):
                vals = [float(v) for v in ln.split(":")[1].split()]
                if not all(math.isfinite(v) for v in vals):
                    raise AssertionError(f"{name}: {ln}")

    def phase_clinical(self) -> None:
        import math

        import numpy as np

        print("== phase 4: coupled transport and thermal", flush=True)
        s = self.sizes
        with tempfile.TemporaryDirectory() as d:
            text, dt = self._cli(
                ["transport", "--case", "coronary", "--coupled", "--steps",
                 str(s.transport_steps), "--out", d]
                + self._opt_args(self.clinical_opts()))
            series = np.loadtxt(os.path.join(d, "coronary_washout.csv"),
                                delimiter=",", skiprows=1, ndmin=2)
            if series.shape[0] != s.transport_steps or not (
                    np.isfinite(series).all()):
                raise AssertionError("coupled transport series")
            print(f"  transport --coupled {s.tree_shape}: "
                  f"{s.transport_steps} steps in {dt:.1f} s wall incl. "
                  f"geometry and compile = {dt / s.transport_steps * 1e3:.2f}"
                  f" ms/step upper bound [{self.card}]", flush=True)
            text, dt = self._cli(
                ["thermal", "--thermal-case", "cavity3d", "--n",
                 str(s.thermal_n), "--steps", str(s.thermal_steps),
                 "--chunks", str(s.thermal_chunks), "--out", d])
        nus = [float(ln.split("Nu=")[1].split()[0])
               for ln in text.splitlines() if "Nu=" in ln]
        if len(nus) != s.thermal_chunks or not all(map(math.isfinite, nus)):
            raise AssertionError(f"thermal Nu {nus}")
        steps = s.thermal_steps * s.thermal_chunks
        print(f"  thermal cavity3d {s.thermal_n}^3: {steps} steps in "
              f"{dt:.1f} s wall incl. compile = {dt / steps * 1e3:.2f} "
              f"ms/step upper bound, Nu {nus} [{self.card}]", flush=True)

    def phase_copy_floor(self) -> None:
        import jax
        import jax.numpy as jnp

        from lbm_jax.utils.profiling import device_op_times

        print("== phase 5: the dense step against the copy floor",
              flush=True)
        s = self.sizes
        sim = self.sim("cavity")
        n = s.floor_steps
        jax.block_until_ready(advance(sim, n))
        t_step = timed_windows(lambda: advance(sim, n), s.floor_windows)

        f = sim.f
        scale = jnp.float32(1.0)

        @jax.jit
        def copy(f, c):
            return jax.lax.scan(lambda x, _: (x * c, None), f, None,
                                length=n)[0]

        jax.block_until_ready(copy(f, scale))
        t_copy = timed_windows(lambda: copy(f, scale), s.floor_windows)
        ms = [t / n * 1e3 for t in t_step]
        mc = [t / n * 1e3 for t in t_copy]
        (a1, a2, a3), (c1, c2, c3) = quartiles(ms), quartiles(mc)
        nbytes = 2 * f.size * 4
        cells = f.size // 19
        print(f"  dense step {s.cavity_n}^3: median {a2:.4f} ms/step "
              f"(q1 {a1:.4f}, q3 {a3:.4f}), {cells / a2 / 1e3:.1f} MLUPS "
              f"[{self.card}]", flush=True)
        print(f"  copy of f (read+write {nbytes / 1e9:.3f} GB): median "
              f"{c2:.4f} ms (q1 {c1:.4f}, q3 {c3:.4f}), "
              f"{nbytes / c2 / 1e6:.1f} GB/s [{self.card}]", flush=True)
        print(f"  step / copy = {a2 / c2:.3f} [{self.card}]", flush=True)

        jax.block_until_ready(advance(sim, s.trace_steps))
        tdir = os.path.join(self.out, "trace")
        with jax.profiler.trace(tdir):
            jax.block_until_ready(advance(sim, s.trace_steps))
        prefix = ("/device:GPU:" if jax.devices()[0].platform == "gpu"
                  else "/host:CPU")
        ops, busy, window = device_op_times(tdir, prefix)
        total = sum(t for _, t, _ in ops) or 1.0
        print(f"  trace {tdir}: {s.trace_steps} steps, {len(ops)} distinct "
              f"device ops, busy {busy / 1e6:.3f} ms of a "
              f"{window / 1e6:.3f} ms window [{self.card}]", flush=True)
        for name, t, cnt in ops[:12]:
            print(f"    {t / 1e6:9.3f} ms {t / total:6.1%} x{cnt:<4d} "
                  f"{name[:100]}", flush=True)

    def phase_four(self, n_dev: int = 4) -> None:
        import jax
        import jax.numpy as jnp
        import numpy as np

        from lbm_jax.cases import get_case
        from lbm_jax.engine.compile import compile_case
        from lbm_jax.engine.runner import Simulation
        from lbm_jax.engine.step import initial_f
        from lbm_jax.parallel.halo import make_halo_step
        from lbm_jax.parallel.mesh import (lattice_mesh, lattice_sharding,
                                           shard_case)

        print(f"== phase 6: flagship tree sharded along y over {n_dev} "
              "devices", flush=True)
        s = self.sizes
        devs = jax.devices()
        if len(devs) < n_dev:
            raise RuntimeError(f"needs {n_dev} devices, have {len(devs)}")
        mesh = lattice_mesh(n_dev)
        # Newtonian here: Carreau's per-cell Picard iterations would
        # triple the one-device reference runs on four charged cards
        # and exercise nothing of the decomposition
        opts = self.clinical_opts(shape=s.four_shape)
        del opts["rheology"]
        n = s.four_steps

        def timed_run(sim):
            sim.run(max_steps=n, time_save=n, verbose=False)  # compile
            jax.block_until_ready(sim.f)
            t0 = time.perf_counter()
            sim.run(max_steps=n, time_save=n, verbose=False)
            jax.block_until_ready(sim.f)
            return (time.perf_counter() - t0) / n * 1e3

        # GSPMD carries the whole clinical composition (the windkessel
        # flux sum spans shards); the halo step takes no windkessel, so
        # it runs the same tree with the reference's prescribed outlets.
        spec_wk = get_case("coronary", **opts)
        opts_halo = {k: v for k, v in opts.items() if k != "windkessel"}
        spec_halo = get_case("coronary", **opts_halo)
        ref = {}
        for name, spec in (("gspmd", spec_wk), ("halo", spec_halo)):
            with jax.default_device(devs[0]):
                sim1 = Simulation(spec)
                ms = timed_run(sim1)
            ref[name] = (sim1.f, sim1.wk)
            print(f"  1-device dense ({name} config): {ms:.3f} ms/step "
                  f"[{self.card}]", flush=True)
            del sim1

        sim = Simulation(spec_wk, mesh=mesh)
        ms = timed_run(sim)
        placed = {d.id for d in sim.f.sharding.device_set}
        if len(placed) != n_dev:
            raise AssertionError(f"GSPMD state on devices {placed}")
        check_parity(f"GSPMD {n_dev} devices vs 1 device, x{2 * n} steps",
                     rel_l2(jax.device_get(sim.f), ref["gspmd"][0]))
        check_parity("GSPMD windkessel P_c",
                     rel_l2(jax.device_get(sim.wk), ref["gspmd"][1]))
        print(f"  GSPMD {n_dev} devices: {ms:.3f} ms/step [{self.card}]",
              flush=True)
        del sim

        cc = shard_case(compile_case(spec_halo), mesh, 1)

        def halo_chunk(cc, f, t):
            step = make_halo_step(cc, mesh, shard_axis=1)

            def body(carry, _):
                f, t = carry
                f, _, _ = step(f, t)
                return (f, t + 1), None

            return jax.lax.scan(body, (f, t), None, length=n)[0]

        chunk = jax.jit(halo_chunk, donate_argnums=(1,))
        f = jax.device_put(initial_f(cc), lattice_sharding(
            axis=1, mesh=mesh, leading=1))
        f, t = chunk(cc, f, jnp.int32(0))
        jax.block_until_ready(f)
        t0 = time.perf_counter()
        f, t = chunk(cc, f, t)
        jax.block_until_ready(f)
        ms = (time.perf_counter() - t0) / n * 1e3
        placed = {d.id for d in f.sharding.device_set}
        if len(placed) != n_dev:
            raise AssertionError(f"halo state on devices {placed}")
        check_parity(f"halo {n_dev} devices vs 1 device, x{2 * n} steps",
                     rel_l2(jax.device_get(f), ref["halo"][0]))
        print(f"  halo shard_map {n_dev} devices: {ms:.3f} ms/step "
              f"[{self.card}]", flush=True)
        if not np.isfinite(np.asarray(jax.device_get(f))).all():
            raise AssertionError("halo state not finite")


def phase_device(card: str) -> None:
    import jax

    from lbm_jax.device import device_info, setup_compile_cache

    cache = setup_compile_cache()
    print("== phase 0: device", flush=True)
    print(f"  jax {jax.__version__}; devices {device_info()}", flush=True)
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache "
          f"{cache}", flush=True)
    print(f"  card (nvidia-smi name, power.limit): {card}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "chip_smoke"),
                    help="directory for the profiler trace")
    args = ap.parse_args(argv)

    from lbm_jax.device import require_gpu

    info = require_gpu()   # raises, before any phase, without a GPU
    card = card_label()
    phase_device(card)
    smoke = Smoke(FULL, card, args.out)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    if args.four:
        smoke.phase_four(4)
        count = 4
    else:
        smoke.phase_compile()
        smoke.phase_parity()
        smoke.phase_main_path()
        smoke.phase_clinical()
        smoke.phase_copy_floor()
        count = info["count"]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
