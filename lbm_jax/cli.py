"""Command-line runner: one engine, N case configs.

Replaces the reference's compile-and-run-per-case workflow
("nvcc Poiseulle.cu -o Poiseulle", Poiseulle_flow/README.md) with:

    python -m lbm_jax run --case lid_driven_cavity --out out/
    python -m lbm_jax run --case bifurcation --steps 4400
    python -m lbm_jax run --case coronary --resume out/coronary.ckpt.npz
    python -m lbm_jax list
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_kv(pairs: list[str]) -> dict:
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def _cmd_transport(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from lbm_jax.cases import get_case

    spec = get_case(args.case, **_parse_kv(args.opt))
    rec = list(range(len(spec.boundaries)))
    inlet_c = {args.inlet: 1.0}
    if args.bolus:
        gate = int(args.bolus)
        inlet_c = {args.inlet:
                   lambda t: jnp.where(t < gate, 1.0, 0.0)}
    t0 = time.perf_counter()
    if args.coupled:
        from lbm_jax.engine.scalar import CoupledTransport

        tr = CoupledTransport(spec, D=args.D, inlet_c=inlet_c,
                              div_fix=False)
        kind = f"coupled ({type(tr).__name__})"
    else:
        from lbm_jax.engine.runner import Simulation
        from lbm_jax.engine.scalar import ScalarTransport

        sim = Simulation(spec)
        sim.run(max_steps=args.flow_steps,
                time_save=min(1000, args.flow_steps), verbose=False)
        u = np.asarray(sim.macro()[1])
        tr = ScalarTransport(spec, u, D=args.D, inlet_c=inlet_c)
        kind = (f"frozen-field ({type(tr).__name__}) after "
                f"{args.flow_steps} flow steps")
    print(f"transport: {kind}, D={args.D}, horizon {args.steps}")
    series = tr.run(args.steps, record=rec)
    dt = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{spec.name}_washout.csv")
    hdr = ",".join(f"bc{k}" for k in rec)
    np.savetxt(path, series, delimiter=",", header="step," + hdr,
               comments="",
               fmt="%.6e")
    print(f"washout series -> {path} ({args.steps} steps, "
          f"{dt:.1f}s total incl. flow/compile)")
    for k in rec:
        print(f"  bc{k}: peak {series[:, k].max():.4f} at step "
              f"{int(series[:, k].argmax())}, final "
              f"{series[-1, k]:.5f}")
    if args.vtk:
        c = np.asarray(tr.concentration())
        from lbm_jax.io.vtk import write_structured_points

        vp = os.path.join(args.out, f"{spec.name}_c_{args.steps}.vtk")
        write_structured_points(
            vp, {"CONCENTRATION": c}, spacing=spec.units.CH,
            origin=(0.0, 0.0, 0.0), binary=True)
        print(f"concentration field -> {vp}")
    return 0


def _cmd_thermal(args) -> int:
    import numpy as np

    from lbm_jax.cases import thermal as tcases
    from lbm_jax.engine.thermal import BuoyantTransport

    if args.thermal_case == "cavity":
        spec, kwargs, info = tcases.heated_cavity(
            n=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 0
    elif args.thermal_case == "rb":
        spec, kwargs, info = tcases.rayleigh_benard(
            nx=2 * args.n, nz=args.n, ra=args.ra, pr=args.pr,
            tau=args.tau)
        hot_axis = 2
    elif args.thermal_case == "cavity3d":
        spec, kwargs, info = tcases.heated_cavity_3d(
            n=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 0
    else:
        nz = args.nz or (args.n // 2 + 2)
        spec, kwargs, info = tcases.rayleigh_benard_3d(
            nx=args.n, ny=args.n, nz=nz, ra=args.ra, pr=args.pr,
            tau=args.tau)
        hot_axis = 2
    bt = BuoyantTransport(spec, **kwargs)
    print(f"thermal: {spec.name} {spec.shape} Ra={args.ra:g} "
          f"Pr={args.pr} ({type(bt).__name__})")
    t0 = time.perf_counter()
    for k in range(args.chunks):
        bt.run(args.steps)
        planes, nu = bt.nusselt_profile(hot_axis, info["kappa"],
                                        info["dT"], info["H"])
        print(f"chunk {k}: t={bt.t}  Nu={float(np.mean(nu)):.4f} "
              f"(spread {np.ptp(nu):.4f})", flush=True)
    dt = time.perf_counter() - t0
    print(f"{args.chunks * args.steps} steps in {dt:.1f}s = "
          f"{dt / (args.chunks * args.steps) * 1e3:.3f} ms/step")
    if args.vtk:
        os.makedirs(args.out, exist_ok=True)
        from lbm_jax.io.vtk import write_structured_points

        c = np.asarray(bt.concentration())
        _, u = bt.macro()
        vp = os.path.join(args.out, f"{spec.name}_{bt.t}.vtk")
        write_structured_points(
            vp, {"TEMPERATURE": c, "VELOCITY": np.asarray(u)},
            spacing=spec.units.CH, origin=(0.0, 0.0, 0.0), binary=True)
        print(f"fields -> {vp}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lbm_jax")
    sub = parser.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a case")
    runp.add_argument("--case", required=True)
    runp.add_argument("--out", default="out")
    runp.add_argument("--steps", type=int, default=None)
    runp.add_argument("--time-save", type=int, default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0,
                      help="save a resumable checkpoint every N saves")
    runp.add_argument("--resume", default=None, help="checkpoint to resume")
    runp.add_argument("--no-vtk", action="store_true")
    runp.add_argument("--vtk-final", action="store_true",
                      help="write VTK only once, after the run finishes "
                      "(per-save VTK on a 31M-cell grid dominates wall "
                      "time; the residual curve still logs every save)")
    runp.add_argument("--binary-vtk", action="store_true")
    runp.add_argument("--wss", action="store_true",
                      help="add the wall-shear-stress field (Pa) to VTK "
                      "outputs (engine/stress.py; beyond-reference)")
    runp.add_argument("--wss-stats", action="store_true",
                      help="accumulate TAWSS (Pa) and OSI over the run "
                      "(sampled at every save; for pulsatile cases make "
                      "--time-save divide the period) and write both "
                      "into the FINAL VTK (engine/stress.WSSAccumulator)")
    runp.add_argument("--snapshots", action="store_true",
                      help="write end-of-run midplane/BC snapshots "
                           "(meas1.txt, s1_out.txt, vel.csv — the "
                           "reference's write_once/outtxt outputs)")
    runp.add_argument("--shard", type=int, default=0,
                      help="shard the lattice over N devices (0 = auto off)")
    runp.add_argument("--backend", default="auto",
                      choices=["auto", "xla", "sparse"],
                      help="step backend (auto: the dense xla step)")
    runp.add_argument("--profile", default=None,
                      help="write a jax.profiler trace to this directory")
    runp.add_argument("--opt", nargs="*", metavar="KEY=VAL",
                      help="case builder options (e.g. n=128 tau=0.55)")

    sub.add_parser("list", help="list available cases")

    # passive scalar transport on a case (washout / residence time) —
    # the one-engine-N-configs surface for engine/scalar
    trp = sub.add_parser(
        "transport",
        help="contrast washout on a case: converge the flow, then run "
        "scalar transport (frozen-field, or --coupled for the "
        "time-resolved scan)")
    trp.add_argument("--case", required=True)
    trp.add_argument("--opt", nargs="*", metavar="KEY=VAL", default=[])
    trp.add_argument("--out", default="out")
    trp.add_argument("--D", type=float, default=0.02,
                     help="lattice diffusivity")
    trp.add_argument("--flow-steps", type=int, default=2000,
                     help="flow convergence horizon before transport "
                     "(frozen route)")
    trp.add_argument("--steps", type=int, default=4000)
    trp.add_argument("--bolus", type=int, default=0,
                     help="inlet c=1 gate length in steps (0 = "
                     "steady inlet c=1)")
    trp.add_argument("--inlet", type=int, default=0,
                     help="inlet boundary index")
    trp.add_argument("--coupled", action="store_true",
                     help="time-resolved: flow + scalar advance in one "
                     "scan (pulsatile/windkessel cases)")
    trp.add_argument("--vtk", action="store_true",
                     help="write the final concentration field")

    thp = sub.add_parser(
        "thermal",
        help="Boussinesq natural convection (cases/thermal.py): "
        "heated cavity / Rayleigh-Benard")
    thp.add_argument("--thermal-case", default="cavity3d",
                     choices=["cavity", "rb", "cavity3d", "rb3d"])
    thp.add_argument("--n", type=int, default=32)
    thp.add_argument("--nz", type=int, default=None)
    thp.add_argument("--ra", type=float, default=1e4)
    thp.add_argument("--pr", type=float, default=0.71)
    thp.add_argument("--tau", type=float, default=0.66)
    thp.add_argument("--steps", type=int, default=5000)
    thp.add_argument("--chunks", type=int, default=4)
    thp.add_argument("--out", default="out")
    thp.add_argument("--vtk", action="store_true")

    args = parser.parse_args(argv)

    if args.cmd == "list":
        from lbm_jax.cases import list_cases

        for name in list_cases():
            print(name)
        return 0

    from lbm_jax.device import setup_compile_cache

    setup_compile_cache()
    if args.cmd == "transport":
        return _cmd_transport(args)
    if args.cmd == "thermal":
        return _cmd_thermal(args)

    from lbm_jax.cases import get_case
    from lbm_jax.engine import checkpoint as ckpt
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.io.convlog import ConvergenceLog
    from lbm_jax.io.vtk import case_vtk

    spec = get_case(args.case, **_parse_kv(args.opt))
    mesh = None
    if args.shard:
        from lbm_jax.parallel.mesh import lattice_mesh

        mesh = lattice_mesh(args.shard)
    sim = Simulation(spec, backend=args.backend, mesh=mesh)
    if args.resume:
        ckpt.restore(sim, args.resume)
        print(f"resumed from {args.resume} at step {sim.t}")

    os.makedirs(args.out, exist_ok=True)
    log = ConvergenceLog(args.out)
    t0 = time.perf_counter()
    save_count = 0
    wss_acc = None

    def on_save(sim, k, residual):
        nonlocal save_count, wss_acc
        save_count += 1
        log.residual(residual)
        if args.wss_stats:
            if wss_acc is None:
                wss_acc = sim.wss_accumulator()
            wss_acc.sample_sim(sim)
        if not args.no_vtk and not args.vtk_final:
            case_vtk(sim, args.out, k, include_density=spec.vtk_density,
                     binary=args.binary_vtk, include_wss=args.wss)
        if args.checkpoint_every and save_count % args.checkpoint_every == 0:
            ckpt.save_sim(
                os.path.join(args.out, f"{spec.name}.ckpt.npz"), sim
            )

    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)
    result = sim.run(
        max_steps=args.steps, time_save=args.time_save, on_save=on_save
    )
    if args.profile:
        import jax

        jax.profiler.stop_trace()

    elapsed_ms = (time.perf_counter() - t0) * 1e3
    import numpy as np

    nlattice = int((np.asarray(spec.mask) != 0).sum())
    print(
        f"TOTAL RUNNING TIME: {elapsed_ms:.1f} MILLI SECONDS "
        f"#LATTICE {nlattice}  {result.mlups:.1f} MLUPS"
    )
    print(f"Residual is {result.residual:g}")
    if sim.wk is not None:
        from lbm_jax.engine.diagnostics import MMHG_PER_PA

        pc = np.asarray(sim.wk) * spec.units.C_pre * MMHG_PER_PA
        print("Windkessel P_c (mmHg gauge): "
              + " ".join(f"{v:.4f}" for v in pc))
    log.finish(elapsed_ms, nlattice, result.residual)
    if not args.no_vtk:
        extra = None
        if wss_acc is not None and wss_acc.n_samples:
            extra = {
                "TAWSS": np.asarray(wss_acc.tawss_field())
                * spec.units.C_pre,
                "OSI": np.asarray(wss_acc.osi_field()),
            }
        case_vtk(sim, args.out, sim.t, include_density=spec.vtk_density,
                 binary=args.binary_vtk, include_wss=args.wss,
                 extra_fields=extra)
    if args.snapshots:
        from lbm_jax.io.snapshots import (
            write_bc_csv,
            write_midplane,
            write_midplane_fluid,
        )

        rho, u = sim.macro()
        u = np.asarray(u)
        write_midplane(os.path.join(args.out, "meas1.txt"), u)
        write_midplane_fluid(
            os.path.join(args.out, "s1_out.txt"), u, spec.mask
        )
        write_bc_csv(os.path.join(args.out, "vel.csv"), u, spec.mask)
    return 0


if __name__ == "__main__":
    sys.exit(main())
