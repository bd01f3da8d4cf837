"""Physiological-blood coronary demo on one GPU: the flagship
composition of the beyond-parity features — the synthetic coronary
tree under the Cho & Kensey Carreau blood model
(core/rheology.carreau_blood, per-cell tau_eff) with wall-shear-stress
output in Pa (engine/stress.py).

The reference solves this geometry Newtonian-only and writes
velocity/pressure only (/root/reference/coronary_cfd/coronary.cu); WSS
under non-Newtonian blood is the quantity clinicians actually read.

Usage: python tools/demo_blood_wss.py [--shape 128,128,160] [--radius 8]
       [--steps 2000] [--newtonian] [--vtk OUT.vtk]
Prints per-stage summary lines to stdout. Default shape keeps the dense
stress pass comfortably in HBM (see Simulation.stress's memory note);
the hot loop itself would take the full 291x291x372.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="128,128,160")
    ap.add_argument("--radius", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--newtonian", action="store_true",
                    help="skip the rheology (comparison run)")
    ap.add_argument("--curved", action="store_true",
                    help="Bouzidi curved walls + SDF-gradient WSS "
                    "normals (coronary curved=True)")
    ap.add_argument("--windkessel", action="store_true",
                    help="terminate all four outlets on 3-element RCR "
                    "models (flow split emerges from downstream "
                    "resistances) and report per-outlet flux, P_c, and "
                    "the CFD-FFR estimate (engine/diagnostics)")
    ap.add_argument("--stenosis", type=float, default=None,
                    help="fractional diameter reduction of a proximal "
                    "main-tube cosine constriction (coronary stenosis=) "
                    "— FFR should drop vs the healthy run. Keep <=0.45 "
                    "at radius 8: throat velocity scales ~(R/r)^2 and "
                    "lattice Ma must stay <0.3")
    ap.add_argument("--vtk", default=None)
    ap.add_argument("--pulsatile", action="store_true",
                    help="run the full pulsatile clinical composition "
                    "instead: curved_vessel's carotid-like series inlet "
                    "+ Carreau blood + one RCR outlet termination + "
                    "TAWSS/OSI accumulated over the final cardiac "
                    "cycle (--shape's first entry is the cube edge n; "
                    "--steps is ignored — cycles are fixed)")
    ap.add_argument("--n", type=int, default=96,
                    help="curved_vessel cube edge for --pulsatile")
    ap.add_argument("--cycles", type=int, default=3,
                    help="cardiac cycles for --pulsatile (last one is "
                    "the TAWSS/OSI + P_c sampling window)")
    args = ap.parse_args()

    import numpy as np

    from lbm_jax.cases import get_case
    from lbm_jax.core.rheology import carreau_blood
    from lbm_jax.engine.runner import Simulation

    if args.pulsatile:
        _pulsatile(args, np, get_case, carreau_blood, Simulation)
        return

    shape = tuple(int(s) for s in args.shape.split(","))
    base = get_case("coronary", shape=shape, radius=args.radius)
    rheo = None if args.newtonian else carreau_blood(base.units)
    # RCR terminations (lattice units): the main outlet drains the
    # trunk, the three sub-outlets carry ~3x its distal resistance, so
    # the split emerges from the resistances (not prescribed speeds).
    wk = ([(2e-4, 2e4, 1e-3)] + [(2e-4, 2e4, 3e-3)] * 3
          if args.windkessel else None)
    spec = get_case("coronary", shape=shape, radius=args.radius,
                    rheology=rheo, curved=args.curved, windkessel=wk,
                    stenosis=args.stenosis)
    print(f"case: coronary {shape} radius={args.radius} "
          f"rheology={'newtonian' if rheo is None else 'carreau_blood'} "
          f"walls={'bouzidi' if args.curved else 'staircase'} "
          f"outlets={'RCR windkessel' if wk else 'prescribed-velocity'} "
          f"stenosis={args.stenosis}")

    t0 = time.perf_counter()
    sim = Simulation(spec)
    print(f"build: backend={sim.backend} "
          f"{time.perf_counter() - t0:.1f}s")

    chunk = min(500, args.steps)
    t0 = time.perf_counter()
    sim.run(max_steps=chunk, time_save=chunk, verbose=False)
    print(f"warmup: first chunk (compile) "
          f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    res = sim.run(max_steps=args.steps, time_save=chunk, verbose=False)
    dt = time.perf_counter() - t0
    ncell = int(np.prod(shape))
    print(f"run: {args.steps} steps in {dt:.1f}s = "
          f"{dt / args.steps * 1e3:.2f} ms/step, "
          f"{ncell * args.steps / dt / 1e6:.1f} MLUPS box-convention, "
          f"residual {res.residual:.3e}")

    if args.windkessel:
        from lbm_jax.engine.diagnostics import (MMHG_PER_PA, ffr,
                                                plane_flux)

        rho_f, u_f = (np.asarray(a) for a in sim.macro())
        names = ["main", "sub5", "sub6", "sub7"]
        qs = [plane_flux(spec, u_f, 1 + k) for k in range(4)]
        qtot = sum(qs)
        pc = np.asarray(sim.wk) * spec.units.C_pre * MMHG_PER_PA
        for k, nm in enumerate(names):
            f_k, dp_k = ffr(spec, rho_f, 0, 1 + k)
            print(f"outlet {nm}: Q {qs[k]:+.2f} ({qs[k]/qtot*100:.0f}% "
                  f"of outflow), P_c {pc[k]:.2f} mmHg gauge, "
                  f"trans-tree dp {dp_k:.2f} mmHg, FFR~{f_k:.3f}")
        # the split is set by the TOTAL path resistance — in-tree
        # viscous segments (8 nu L / pi R^4 ~ 1e-2 here) plus each
        # RCR's Rd — so it shifts with geometry as much as with the
        # terminations; the quantitative RCR anchors live in
        # tests/test_windkessel.py on the single-path pipe.
        assert np.isfinite(pc).all() and qtot > 0 and all(
            np.isfinite(q) for q in qs)

    t0 = time.perf_counter()
    w = np.asarray(sim.wss()) * spec.units.C_pre  # Pa
    wall = w > 0
    print(f"wss: {wall.sum()} wall-adjacent cells, "
          f"mean {w[wall].mean():.3f} Pa, p95 "
          f"{np.percentile(w[wall], 95):.3f} Pa, max {w[wall].max():.3f} "
          f"Pa ({time.perf_counter() - t0:.1f}s)")
    assert np.isfinite(w).all()

    if args.vtk:
        from lbm_jax.io.vtk import case_vtk

        t0 = time.perf_counter()
        path = case_vtk(sim, os.path.dirname(args.vtk) or ".", sim.t,
                        binary=True, include_wss=True)
        print(f"vtk: {path} ({os.path.getsize(path) / 1e6:.1f} MB, "
              f"{time.perf_counter() - t0:.1f}s)")


def _pulsatile(args, np, get_case, carreau_blood, Simulation):
    """The full pulsatile clinical pipeline in one run: curved_vessel's
    time-periodic series inlet (the unsteady-BC capability the
    reference describes but never shipped — curved vessel/README.md,
    thesis section 4.5-E) + Cho & Kensey Carreau blood + a 3-element
    RCR outlet termination + TAWSS/OSI accumulated over the final
    cardiac cycle. The outlet pressure must TRACK the inlet waveform
    (the point of the windkessel vs the reference's pinned rho=1), with
    the compliance C setting the diastolic decay (here Rd*C = half a
    period, so P_c swings but does not follow the waveform rigidly)."""
    import time

    from lbm_jax.engine.diagnostics import MMHG_PER_PA, plane_flux

    n, nphase, period = args.n, 40, 1200
    stride = period // nphase
    base = get_case("curved_vessel", n=n)
    rheo = carreau_blood(base.units)
    wk = (2e-4, 0.5 * period / 2e-3, 2e-3)  # Rp, C, Rd (lattice)
    spec = get_case("curved_vessel", n=n, nphase=nphase,
                    period_steps=period, windkessel=wk, rheology=rheo)
    print(f"case: curved_vessel n={n} nphase={nphase} "
          f"period={period} steps, carreau_blood + RCR outlet "
          f"Rp={wk[0]:g} C={wk[1]:g} Rd={wk[2]:g} (lattice)")

    t0 = time.perf_counter()
    sim = Simulation(spec)
    print(f"build: backend={sim.backend} {time.perf_counter()-t0:.1f}s")

    warm = (args.cycles - 1) * period
    t0 = time.perf_counter()
    sim.run(max_steps=warm, time_save=period // 4, verbose=False)
    dt = time.perf_counter() - t0
    print(f"warmup: {args.cycles - 1} cycles ({warm} steps) in {dt:.1f}s"
          f" = {dt / warm * 1e3:.2f} ms/step (incl. compile)")

    # final cycle: sample the traction vector at every inlet phase and
    # track the RCR pressure + outward outlet flux over the waveform
    acc = sim.wss_accumulator()
    pcs, qs = [], []
    t0 = time.perf_counter()
    for _ in range(nphase):
        sim.run(max_steps=stride, time_save=stride, verbose=False)
        acc.sample_sim(sim)
        _, u_f = (np.asarray(a) for a in sim.macro())
        pcs.append(float(np.asarray(sim.wk)[0]))
        qs.append(plane_flux(spec, u_f, 1))
    print(f"sampling cycle: {nphase} phases in "
          f"{time.perf_counter()-t0:.1f}s")

    to_mmhg = spec.units.C_pre * MMHG_PER_PA
    pcs, qs = np.asarray(pcs), np.asarray(qs)
    print(f"outlet P_c over the cycle: min {pcs.min()*to_mmhg:.3f} / "
          f"max {pcs.max()*to_mmhg:.3f} mmHg gauge "
          f"(pulse {np.ptp(pcs)*to_mmhg:.3f} mmHg)")
    retro = float((qs < 0).mean())
    note = (f"{retro:.0%} of phases retrograde — the diastolic flow "
            f"reversal that drives OSI" if retro else "no retrograde "
            "phases at this size")
    print(f"outlet flux over the cycle: min {qs.min():+.3f} / "
          f"max {qs.max():+.3f} lattice ({note})")
    assert np.isfinite(pcs).all() and np.isfinite(qs).all()
    assert np.ptp(pcs) > 0.05 * pcs.max(), "P_c must track the waveform"

    tawss = np.asarray(acc.tawss_field()) * spec.units.C_pre  # Pa
    osi = np.asarray(acc.osi_field())
    wall = tawss > 0
    print(f"tawss: {wall.sum()} wall-adjacent cells, mean "
          f"{tawss[wall].mean():.3f} Pa, p95 "
          f"{np.percentile(tawss[wall], 95):.3f} Pa")
    print(f"osi: median {np.median(osi[wall]):.4f}, p95 "
          f"{np.percentile(osi[wall], 95):.4f}, max {osi[wall].max():.4f}")
    assert np.isfinite(tawss).all() and np.isfinite(osi).all()


if __name__ == "__main__":
    main()
