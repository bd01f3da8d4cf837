#!/usr/bin/env python
"""Adjoint outlet-calibration demo on one GPU.

The FFR-CT-class calibration task: the synthetic coronary tree gets a
velocity inlet and 4 RCR outlet terminations, and we must choose the
distal resistances Rd so the computed flow SPLIT matches a measured
per-branch target — the allocation the reference hard-codes as outlet
speeds (coronary.cu:795-942). Here it is gradient descent with the
EXACT discrete adjoint: jax.grad through the full remat'd rollout
(engine/adjoint.py), something the CUDA reference's in-place kernels
can never provide.

Stages:
  1. fit: optax.adam on log Rd, loss = ||split(rollout) - target||^2,
     one forward+backward per iterate on the device.
  2. verify: run the PLAIN production Simulation with the fitted RCRs
     to convergence and measure the split with the clinical plane
     diagnostics — the fit must transfer out of the adjoint horizon.

Usage: python tools/demo_adjoint.py [--shape 96,96,120 --radius 7]
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
    ap.add_argument("--target", default="0.40,0.27,0.20,0.13",
                    help="per-outlet flow-split target "
                    "(main, sub5, sub6, sub7)")
    ap.add_argument("--steps", type=int, default=600,
                    help="rollout horizon inside the loss")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--chunk", type=int, default=30,
                    help="remat chunk (peak mem ~ (steps/chunk + chunk)"
                    " states)")
    ap.add_argument("--verify-steps", type=int, default=4000)
    args = ap.parse_args()

    import jax

    from lbm_jax.cases import get_case
    from lbm_jax.engine.adjoint import fit_windkessel, wk_params
    from lbm_jax.engine.diagnostics import plane_flux

    shape = tuple(int(s) for s in args.shape.split(","))
    target = np.asarray([float(s) for s in args.target.split(",")],
                        np.float32)
    assert abs(target.sum() - 1.0) < 1e-6, "target split must sum to 1"
    wk0 = [(1e-4, 5e3, 2e-3)] * 4          # uniform start: wrong split
    spec = get_case("coronary", shape=shape, radius=args.radius,
                    windkessel=wk0)
    print(f"device: {jax.devices()[0].platform}; case: coronary "
          f"{shape} radius={args.radius}, 4 RCR outlets, uniform "
          f"Rd={wk0[0][2]:g} start")
    print(f"target split: {' '.join(f'{t:.3f}' for t in target)}")

    t0 = time.perf_counter()
    theta, hist = fit_windkessel(spec, target, n_steps=args.steps,
                                 iters=args.iters, lr=args.lr,
                                 remat_chunk=args.chunk, verbose=True)
    dt = time.perf_counter() - t0
    print(f"fit: {args.iters} adjoint iterations ({args.steps}-step "
          f"rollouts) in {dt:.1f}s = {dt/args.iters:.1f} s/iter "
          f"(forward+backward)")
    print("fitted Rd:", " ".join(f"{r:.4e}" for r in theta[:, 2]))
    print(f"loss {hist[0][0]:.3e} -> {hist[-1][0]:.3e}")

    # stage 2: the fitted terminations must transfer to the production
    # solver at a convergence-scale horizon
    from lbm_jax.engine.runner import Simulation

    spec_v = get_case("coronary", shape=shape, radius=args.radius,
                      windkessel=[tuple(map(float, row))
                                  for row in theta])
    sim = Simulation(spec_v)
    t0 = time.perf_counter()
    sim.run(max_steps=args.verify_steps, time_save=args.verify_steps,
            verbose=False)
    _, u = (np.asarray(a) for a in sim.macro())
    idx = [k for k, b in enumerate(spec_v.boundaries)
           if b.windkessel is not None]
    q = np.asarray([plane_flux(spec_v, u, k) for k in idx])
    split = q / q.sum()
    print(f"verify: plain Simulation, {args.verify_steps} steps in "
          f"{time.perf_counter()-t0:.1f}s")
    print(f"converged split: {' '.join(f'{s:.3f}' for s in split)}")
    err = np.abs(split - target).max()
    print(f"max |split - target| = {err:.4f}")
    assert err < 0.03, "fitted terminations must hit the target split"
    print("OK")


if __name__ == "__main__":
    main()
