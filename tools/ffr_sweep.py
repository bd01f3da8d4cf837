"""FFR-vs-severity sweep, resting AND hyperemic (VERDICT r4 next-#7):
clinical ischemia grading runs hyperemic flow (3-5x the resting inlet
rate, adenosine-induced) where the stenosis throat's quadratic loss
pushes FFR toward the 0.80 treatment threshold — the resting-flow runs
of r4 (FFR 0.984 vs 0.992) never crossed clinical significance.

Hyperemia here rescales the UNIT SYSTEM at fixed lattice speed
(cases/coronary.py hyperemia=): physical flow h-fold up, tau down to
hold the physical viscosity, lattice Ma unchanged anywhere (the throat
is the Ma-limiting site). TRT collision for stability at the reduced
tau. Outlets keep the reference's prescribed-velocity form, so the
flux through the lesion is pinned and dp reads the lesion loss.

Usage: python tools/ffr_sweep.py [--shape 128,64,96] [--radius 10]
         [--sev 0,0.2,0.3,0.4,0.5] [--hyper 3.5] [--steps 4000]
Smoke: JAX_PLATFORMS=cpu python tools/ffr_sweep.py \
         --shape 64,32,48 --radius 5 --sev 0,0.4 --steps 150
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="128,64,96")
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--sev", default="0,0.2,0.3,0.4,0.5")
    ap.add_argument("--hyper", type=float, default=3.5)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--tau", type=float, default=0.56)
    ap.add_argument("--cs", type=float, default=0.12,
                    help="Smagorinsky Cs for the HYPEREMIC runs: the "
                    "rescaled tau (~0.517 at h=3.5) NaNs the staircase "
                    "tree bare — the r5 LES+TRT pairing (constant "
                    "magic Lambda) stabilizes it; 0 disables")
    args = ap.parse_args()

    import numpy as np

    from lbm_jax.cases import get_case
    from lbm_jax.engine.diagnostics import ffr
    from lbm_jax.engine.runner import Simulation

    shape = tuple(int(s) for s in args.shape.split(","))
    sevs = [float(s) for s in args.sev.split(",")]

    def run_one(sev, h):
        spec = get_case(
            "coronary", shape=shape, radius=args.radius,
            tau=args.tau, collision="trt",
            stenosis=None if sev == 0.0 else sev,
            hyperemia=h,
            smagorinsky_cs=(args.cs if h > 1.0 and args.cs else None))
        sim = Simulation(spec)
        t0 = time.perf_counter()
        # the hyperemic lattice viscosity is h-fold smaller, so the
        # development time is h-fold MORE steps — scale the horizon or
        # the healthy tree reads an unconverged (even negative) dp
        n_steps = int(args.steps * h)
        sim.run(max_steps=n_steps, time_save=min(1000, n_steps),
                verbose=False)
        rho, _ = (np.asarray(a) for a in sim.macro())
        f_main, dp = ffr(spec, rho, 0, 1)
        return f_main, dp, time.perf_counter() - t0, spec

    print(f"coronary {shape} radius={args.radius} tau={args.tau} TRT; "
          f"hyperemic factor {args.hyper} (physical flow, fixed "
          f"lattice Ma)", flush=True)
    print(f"{'sev':>5} {'dp rest':>9} {'dp hyper':>9} "
          f"{'FFR rest':>9} {'FFR hyper':>10}   (lesion-attributed: "
          f"dp(sev) - dp(0) per state — the healthy tree carries an "
          f"O(Ma^2) plane offset that cancels in the difference)")
    assert sevs[0] == 0.0, "sev list must start at 0 (the baseline)"
    base = {}
    rows = []
    for sev in sevs:
        _, dpr, tr, spec_r = run_one(sev, 1.0)
        _, dph, th, _ = run_one(sev, args.hyper)
        if sev == 0.0:
            base = {"r": dpr, "h": dph}
        p_a = 90.0
        fr = (p_a - (dpr - base["r"])) / p_a
        fh = (p_a - (dph - base["h"])) / p_a
        rows.append((sev, fr, fh))
        print(f"{sev:5.2f} {dpr:7.2f}mm {dph:7.2f}mm {fr:9.3f} "
              f"{fh:10.3f}   [{tr:.0f}s + {th:.0f}s]", flush=True)
    rows = np.asarray(rows)
    assert np.all(np.diff(rows[:, 1]) <= 5e-3), \
        "resting FFR must fall with severity"
    sig = rows[:, 0] > 0
    assert np.all(rows[sig, 2] <= rows[sig, 1] + 1e-6), \
        "hyperemic FFR must not exceed resting FFR at real lesions"
    if (rows[:, 2] < 0.80).any():
        s_cross = rows[rows[:, 2] < 0.80][0, 0]
        print(f"hyperemic FFR crosses the 0.80 ischemia threshold at "
              f"severity {s_cross:.2f} (resting stays "
              f"{rows[:, 1].min():.3f})", flush=True)
    print("OK", flush=True)


if __name__ == "__main__":
    main()
