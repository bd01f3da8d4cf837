#!/usr/bin/env python
"""Boussinesq natural convection on one GPU: the de Vahl Davis heated
cavity (engine/thermal.BuoyantTransport) at a chosen size/Rayleigh
number — prints the converged mean Nusselt number vs the benchmark and
the measured ms/step of the coupled flow+temperature scan.

The thermal step is the D3Q19 flow step + a D3Q7 ADE step + one
7-channel reduction for the buoyancy field, all in one lax.scan body on
the dense-XLA backend. Completion is forced by fetching a SCALAR (the
kinetic-energy sample), so no field transfer is billed to the step
time.

Usage: python tools/demo_thermal.py [--n 26] [--ny 1] [--ra 1e3]
       [--tau 0.66] [--chunks 6 --steps 5000]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

BENCH = {1e3: 1.118, 1e4: 2.243, 1e5: 4.519}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=26)
    ap.add_argument("--ny", type=int, default=1,
                    help="spanwise depth (1 = exact 2D dynamics; >1 "
                    "exercises the full 3D box)")
    ap.add_argument("--ra", type=float, default=1e3)
    ap.add_argument("--pr", type=float, default=0.71)
    ap.add_argument("--tau", type=float, default=0.66)
    ap.add_argument("--steps", type=int, default=5000,
                    help="steps per chunk")
    ap.add_argument("--chunks", type=int, default=6)
    ap.add_argument("--vtk", default=None,
                    help="write TEMPERATURE + VELOCITY fields here")
    args = ap.parse_args()

    import jax

    from lbm_jax.cases.thermal import heated_cavity
    from lbm_jax.engine.thermal import BuoyantTransport

    spec, kw, info = heated_cavity(n=args.n, ny=args.ny, ra=args.ra,
                                   pr=args.pr, tau=args.tau)
    print(f"device: {jax.devices()[0].platform}; cavity "
          f"{args.n}x{args.ny}x{args.n}; Ra={args.ra:g} Pr={args.pr} "
          f"nu={info['nu']:.4f} kappa={info['kappa']:.4f} "
          f"buoyancy={info['b']:.3e}")

    bt = BuoyantTransport(spec, **kw)
    e = bt.run(args.steps, record_energy=True)   # compile + warm
    t0 = time.time()
    for _ in range(args.chunks - 1):
        e = bt.run(args.steps, record_energy=True)
    float(e[-1])                                  # force completion
    dt = time.time() - t0
    n_steps = args.steps * (args.chunks - 1)
    ms = 1e3 * dt / n_steps
    drift = abs(float(e[-1]) - float(e[0])) / max(abs(float(e[0])),
                                                  1e-30)
    planes, nu = bt.nusselt_profile(hot_axis=0, kappa=info["kappa"],
                                    dT=info["dT"], H=info["H"])
    ref = BENCH.get(args.ra)
    ref_s = (f" (de Vahl Davis {ref}; err "
             f"{abs(nu.mean() - ref) / ref * 100:.1f}%)" if ref else "")
    print(f"steady: last-chunk energy drift {drift:.2e}; "
          f"Nu profile [{nu.min():.4f}, {nu.max():.4f}] "
          f"plane-spread {(nu.max() - nu.min()) / nu.mean() * 100:.2f}%")
    print(f"Nu = {nu.mean():.4f}{ref_s}")
    print(f"{ms:.3f} ms per coupled flow+temperature step "
          f"({n_steps} steps warm, {dt:.1f} s)")

    if args.vtk:
        from lbm_jax.io.vtk import write_structured_points
        _, u = bt.macro()
        write_structured_points(
            args.vtk,
            {"TEMPERATURE": np.asarray(bt.concentration()),
             "VELOCITY": np.asarray(u)},
            spacing=1.0, origin=(0.0, 0.0, 0.0), binary=True,
            header="lbm_jax Boussinesq heated-cavity demo")
        print(f"vtk: {args.vtk} "
              f"({os.path.getsize(args.vtk) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
