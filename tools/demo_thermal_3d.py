#!/usr/bin/env python
"""3D Boussinesq natural convection at scale: the cubical
differentially-heated cavity (Tric et al. 2000 benchmark) or a walled
3D Rayleigh-Benard box through engine/thermal.BuoyantTransport (the
dense flow step in per-cell force-field mode + the coupled D3Q7
scalar) — the 128^3-256^3 3D configuration.

Usage:
  python tools/demo_thermal_3d.py --case cavity --n 128 --ra 1e5
  python tools/demo_thermal_3d.py --case rb --n 128 --nz 66 --ra 1e4

Smoke: JAX_PLATFORMS=cpu python tools/demo_thermal_3d.py \
           --case cavity --n 12 --ra 1e3 --steps 50 --chunks 2
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Tric, Labrosse & Betrouni (2000) cubical-cavity hot-wall Nusselt
TRIC = {1e3: 1.0700, 1e4: 2.0542, 1e5: 4.3370, 1e6: 8.6407}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("cavity", "rb"), default="cavity")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--nz", type=int, default=None,
                    help="rb: plate separation extent (default n/2+2)")
    ap.add_argument("--ra", type=float, default=1e4)
    ap.add_argument("--pr", type=float, default=0.71)
    ap.add_argument("--tau", type=float, default=0.60)
    ap.add_argument("--steps", type=int, default=5000,
                    help="steps per chunk")
    ap.add_argument("--chunks", type=int, default=8)
    args = ap.parse_args()

    import jax

    from lbm_jax.cases.thermal import heated_cavity_3d, rayleigh_benard_3d
    from lbm_jax.engine.thermal import BuoyantTransport

    if args.case == "cavity":
        spec, kwargs, info = heated_cavity_3d(
            n=args.n, ra=args.ra, pr=args.pr, tau=args.tau)
        hot_axis = 0
    else:
        nz = args.nz or (args.n // 2 + 2)
        spec, kwargs, info = rayleigh_benard_3d(
            nx=args.n, ny=args.n, nz=nz, ra=args.ra, pr=args.pr,
            tau=args.tau)
        hot_axis = 2
    ncell = int(np.prod(spec.shape))
    print(f"case: {spec.name} {spec.shape} Ra={args.ra:g} "
          f"Pr={args.pr} tau={args.tau} (kappa={info['kappa']:.4f}, "
          f"|b|={info['b']:.3e}, H={info['H']})", flush=True)

    t0 = time.perf_counter()
    bt = BuoyantTransport(spec, **kwargs)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    def fetch():
        jax.block_until_ready(bt.g)

    t0 = time.perf_counter()
    bt.run(min(200, args.steps))
    fetch()
    print(f"warmup: compile + 200 steps {time.perf_counter()-t0:.1f}s",
          flush=True)

    nu_hist = []
    for k in range(args.chunks):
        t0 = time.perf_counter()
        bt.run(args.steps)
        fetch()
        dt = time.perf_counter() - t0
        planes, nu = bt.nusselt_profile(hot_axis, info["kappa"],
                                        info["dT"], info["H"])
        nu_mean = float(np.mean(nu))
        nu_hist.append(nu_mean)
        print(f"chunk {k}: {args.steps} steps in {dt:.1f}s = "
              f"{dt/args.steps*1e3:.3f} ms/step "
              f"({ncell*args.steps/dt/1e6:.0f} MLUPS box-convention) "
              f"Nu={nu_mean:.4f} (plane spread "
              f"{np.ptp(nu)/max(abs(nu_mean),1e-9)*100:.1f}%)",
              flush=True)

    if args.case == "cavity" and args.ra in TRIC:
        ref = TRIC[args.ra]
        err = abs(nu_hist[-1] - ref) / ref * 100
        print(f"benchmark: Tric cubical cavity Ra={args.ra:g} "
              f"Nu={ref} — measured {nu_hist[-1]:.4f} ({err:.1f}%)",
              flush=True)
    assert np.isfinite(nu_hist).all()
    print("OK", flush=True)


if __name__ == "__main__":
    main()
