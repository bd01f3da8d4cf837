"""Flagship clinical pulsatile contrast washout on one GPU: the
291x291x372 synthetic coronary tree (the reference case's scale-out
shape, coronary.cu:19) with a systole/diastole-gated series inlet, four
RCR windkessel outlet terminations, and a time-gated contrast bolus
advecting in the LIVE pulsatile velocity — the dense flow step and the
coupled D3Q7 scalar in one scan (engine/scalar.CoupledTransport),
windkessel P_c riding the scan carry. A frozen-field transport would be
the wrong physics for pulsatile flow.

Usage: python tools/demo_clinical_washout.py [--shape 291,291,372]
         [--radius 10] [--spinup 2000] [--steps 6000] [--bolus 1500]
Prints per-stage timings + the washout curve summary. Small smoke run:
  JAX_PLATFORMS=cpu python tools/demo_clinical_washout.py \
      --shape 48,24,40 --radius 5 --spinup 40 --steps 80 --bolus 20
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="291,291,372")
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--spinup", type=int, default=2000,
                    help="coupled steps before the bolus opens (flow "
                    "develops; scalar stays zero)")
    ap.add_argument("--steps", type=int, default=6000,
                    help="recorded washout steps after spin-up")
    ap.add_argument("--bolus", type=int, default=1500,
                    help="bolus gate length in steps (inlet c=1 while "
                    "t_rec < bolus, 0 after)")
    ap.add_argument("--period", type=int, default=2000,
                    help="cardiac period in steps (series stride = "
                    "period / 40 phases)")
    ap.add_argument("--tau_g", type=float, default=0.6)
    ap.add_argument("--chunk", type=int, default=500)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from lbm_jax.cases import get_case
    from lbm_jax.engine.scalar import CoupledTransport

    shape = tuple(int(s) for s in args.shape.split(","))
    wk = [(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3
    spec = get_case("coronary", shape=shape, radius=args.radius,
                    windkessel=wk, pulsatile=(40, args.period))
    print(f"case: coronary {shape} radius={args.radius} pulsatile "
          f"period={args.period} + 4 RCR outlets + coupled transport "
          f"(tau_g={args.tau_g})", flush=True)

    t_gate = args.spinup + args.bolus
    bolus = {0: lambda t: jnp.where((t >= args.spinup)
                                    & (t < t_gate), 1.0, 0.0)}
    REC = [0, 1, 2, 3, 4]   # boundaries: inlet, main, sub5, sub6, sub7
    NAMES = ["inlet", "main", "sub5", "sub6", "sub7"]
    t0 = time.perf_counter()
    ct = CoupledTransport(spec, tau_g=args.tau_g, inlet_c=bolus,
                          div_fix=False)
    print(f"build: {time.perf_counter() - t0:.1f}s", flush=True)

    # spin-up (compile + flow development; bolus still gated off)
    t0 = time.perf_counter()
    ct.run(min(args.chunk, args.spinup), record=REC)
    print(f"warmup: first chunk (compile) "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    left = args.spinup - min(args.chunk, args.spinup)
    t0 = time.perf_counter()
    while left > 0:
        n = min(args.chunk, left)
        ct.run(n, record=REC)
        left -= n
    if args.spinup > args.chunk:
        dt = time.perf_counter() - t0
        n_done = args.spinup - min(args.chunk, args.spinup)
        print(f"spinup: {n_done} steps in {dt:.1f}s = "
              f"{dt / n_done * 1e3:.2f} ms/step", flush=True)

    # recorded washout
    series = []
    t0 = time.perf_counter()
    left = args.steps
    while left > 0:
        n = min(args.chunk, left)
        series.append(ct.run(n, record=REC))
        left -= n
    dt = time.perf_counter() - t0
    series = np.concatenate(series, axis=0)  # (steps, 5)
    ncell = int(np.prod(shape))
    print(f"washout: {args.steps} steps in {dt:.1f}s = "
          f"{dt / args.steps * 1e3:.2f} ms/step "
          f"({ncell * args.steps / dt / 1e6:.1f} MLUPS box-convention, "
          f"flow+transport per step)", flush=True)

    names = NAMES
    pk = series.max(axis=0)
    tpk = series.argmax(axis=0)
    print(f"bolus: inlet gate {args.bolus} steps; plane curves "
          f"(sub-outlet transit is SLOW: branch u ~ Q/(pi r^2) is "
          f"~1e-2 lattice, arrival takes O(50k) steps at rest):")
    for k, nm in enumerate(names):
        tail = series[-1, k]
        print(f"  {nm}: peak c {pk[k]:.3f} at step {tpk[k]}, "
              f"final c {tail:.4f}")
    pc = np.asarray(ct.wk)
    print(f"windkessel P_c (lattice): {pc}")
    tot = ct.total()
    print(f"scalar total (conservation audit): {tot:.3f}")
    assert np.isfinite(series).all() and np.isfinite(pc).all()
    assert pk[:2].max() > 1e-2, "bolus never entered the tree"
    print("OK", flush=True)


if __name__ == "__main__":
    main()
