#!/usr/bin/env python
"""Contrast washout + residence time on the coronary tree (one GPU).

The transport stage the reference's velocity/pressure output feeds in a
clinic: inject a contrast bolus at the inlet of the CONVERGED coronary
flow and track each outlet's concentration curve (arrival / peak /
washout half-time — the per-branch transit times), then switch the
source on (mean-age mode) and map the residence time field, the
recirculation/stasis marker that complements OSI. Both run on the
frozen converged velocity via the D3Q7 ADE distribution
(engine/scalar.py) — 7 channels, so the transport scan is ~1/3 the
cost of a flow step.

Usage: python tools/demo_washout.py [--shape 96,96,120 --radius 7]
       [--vtk out.vtk]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="96,96,120")
    ap.add_argument("--radius", type=int, default=7)
    ap.add_argument("--flow-steps", type=int, default=4000)
    ap.add_argument("--bolus", type=int, default=400,
                    help="inlet gate length (steps)")
    ap.add_argument("--steps", type=int, default=12000,
                    help="transport steps per stage (must cover the "
                    "slowest branch's transit — the distal outlet on "
                    "the default tree peaks near step 6000)")
    ap.add_argument("--D", type=float, default=0.02,
                    help="lattice diffusivity")
    ap.add_argument("--vtk", default=None,
                    help="write AGE + CONTRAST fields here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from lbm_jax.cases import get_case
    from lbm_jax.engine.runner import Simulation
    from lbm_jax.engine.scalar import ScalarTransport

    shape = tuple(int(s) for s in args.shape.split(","))
    spec = get_case("coronary", shape=shape, radius=args.radius)
    outlets = list(range(1, len(spec.boundaries)))
    print(f"device: {jax.devices()[0].platform}; coronary {shape} "
          f"radius={args.radius}; {len(outlets)} outlets; D={args.D}")

    t0 = time.perf_counter()
    sim = Simulation(spec)
    res = sim.run(max_steps=args.flow_steps, time_save=500,
                  verbose=False)
    _, u = sim.macro()
    print(f"flow: {sim.t} steps in {time.perf_counter()-t0:.1f}s "
          f"(residual {res.residual:.2e})")

    # stage 1: bolus washout curves per outlet
    tb = args.bolus
    gate = lambda t: jnp.where(t < tb, 1.0, 0.0)  # noqa: E731
    st = ScalarTransport(spec, u, D=args.D, inlet_c={0: gate})
    t0 = time.perf_counter()
    series = st.run(args.steps, record=outlets)
    dt = time.perf_counter() - t0
    print(f"bolus: {args.steps} transport steps in {dt:.1f}s = "
          f"{dt/args.steps*1e3:.2f} ms/step")
    ct = spec.units.C_T
    for j, k in enumerate(outlets):
        cur = series[:, j]
        peak = float(cur.max())
        tp = int(cur.argmax())
        arr = int(np.argmax(cur > 0.05 * peak)) if peak > 0 else -1
        post = cur[tp:]
        below = np.nonzero(post < 0.5 * peak)[0]
        half = tp + int(below[0]) if len(below) else None
        t12 = (f"{half} ({half*ct*1e3:.1f} ms)" if half is not None
               else f"beyond horizon (c[end] = {cur[-1]:.3f})")
        print(f"  outlet {k}: arrival {arr} steps ({arr*ct*1e3:.1f} ms)"
              f", peak {peak:.3f} @ {tp}, washout t1/2 {t12}")
        # Slow distal branches dilute a short bolus heavily (the
        # 400-step gate spreads over a ~3000-step transit), so the
        # arrival criterion is absolute-but-small, not near-inlet.
        assert peak > 1e-3, "bolus must reach every outlet"
    assert np.isfinite(series).all()

    # stage 2: mean-age (residence time) field
    st2 = ScalarTransport(spec, u, D=args.D, inlet_c={0: 0.0},
                          source=1.0)
    t0 = time.perf_counter()
    st2.run(args.steps)
    age = np.asarray(st2.concentration())
    fl = np.asarray(st2.fluid)
    a = age[fl]
    print(f"age: {args.steps} steps in {time.perf_counter()-t0:.1f}s; "
          f"mean {a.mean()*ct*1e3:.1f} ms, p95 "
          f"{np.percentile(a, 95)*ct*1e3:.1f} ms, max "
          f"{a.max()*ct*1e3:.1f} ms (stasis pockets)")
    assert np.isfinite(a).all() and a.min() >= 0

    if args.vtk:
        from lbm_jax.io.vtk import write_structured_points
        write_structured_points(
            args.vtk,
            {"AGE_s": age * ct,
             "CONTRAST": np.asarray(st.concentration())},
            spacing=spec.units.CH, origin=(0.0, 0.0, 0.0),
            crops=spec.vtk_crops, binary=True,
            header="lbm_jax washout/residence-time demo")
        print(f"vtk: {args.vtk} ({os.path.getsize(args.vtk)/1e6:.1f} MB)")
    print("OK")


if __name__ == "__main__":
    main()
