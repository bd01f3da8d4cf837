"""Headline benchmark: D3Q19 BGK lid-driven cavity at 256^3 on one chip.

Prints ONE JSON line: MLUPS (million lattice-site updates per second,
the reference's own metric, thesis section 4.9.1) and the ratio vs the
reference's published 391.86 MLUPS (GTX 1050 Ti, BASELINE.md). Site count
follows the reference's convention of the full padded grid
(ldc.cu:54,689: NLATTICE = whole block-padded box).

Usage: python bench.py [--n 256] [--steps 200]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# The reference CUDA program's own published figure on its own card
# (thesis section 4.9.1, lid cavity 64^3 fp32, GTX 1050 Ti) — not a
# measurement of this program.
BASELINE_MLUPS = 391.86


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--case", default="lid_driven_cavity")
    p.add_argument("--backend", default="auto")
    p.add_argument(
        "--shard", type=int, default=0, metavar="N",
        help="shard over the first N devices (1-D mesh along the case's "
        "BC-free axis; BASELINE configs[5] multi-chip path). 0 = off.",
    )
    p.add_argument(
        "--opt", nargs="*", metavar="KEY=VAL", default=[],
        help="case builder options, e.g. --case coronary "
        "--opt 'shape=[291,291,372]' radius=10 --shard 1 for the "
        "BASELINE scale-out shape",
    )
    args = p.parse_args()

    import jax
    import numpy as np

    from lbm_jax.cases import get_case
    from lbm_jax.device import require_gpu, setup_compile_cache
    from lbm_jax.engine.runner import Simulation

    device = require_gpu()
    setup_compile_cache()

    opts = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        try:
            opts[k] = json.loads(v)
        except json.JSONDecodeError:
            opts[k] = v
    if "shape" in opts:
        opts["shape"] = tuple(opts["shape"])
    try:
        spec = get_case(args.case, n=args.n, **opts)
    except TypeError:  # case builder without an `n` knob (e.g. coronary)
        spec = get_case(args.case, **opts)
    mesh = None
    if args.shard:
        from jax.sharding import Mesh

        devs = jax.devices()
        if len(devs) < args.shard:
            print(
                json.dumps({
                    "metric": f"SKIPPED: --shard {args.shard} needs "
                    f"{args.shard} devices, have {len(devs)}",
                    "value": 0, "unit": "MLUPS", "vs_baseline": 0,
                })
            )
            return 0
        mesh = Mesh(np.array(devs[: args.shard]), ("d",))
    sim = Simulation(spec, backend=args.backend, mesh=mesh)
    run = sim._chunk(args.steps)
    # Warmup call compiles the scan; only steady-state execution is timed.
    # Fetching the per-step residual series forces completion.
    sim.f, _, s = run(sim.f, 0)
    _ = np.asarray(s)

    t0 = time.perf_counter()
    sim.f, _, s = run(sim.f, args.steps)
    _ = np.asarray(s)
    elapsed = time.perf_counter() - t0

    # Site count from the case actually built (a builder without an `n`
    # knob keeps its default shape — args.n**3 would misreport it); the
    # reference's NLATTICE convention is the full box (ldc.cu:54,689).
    shape = tuple(int(s) for s in spec.shape)
    nsites = int(np.prod(shape))
    mlups = nsites * args.steps / elapsed / 1e6
    dims = "x".join(str(s) for s in shape)
    chips = f"{args.shard} chips" if args.shard else "1 chip"
    print(
        json.dumps(
            {
                "metric": f"MLUPS (D3Q19 "
                f"{spec.collision.upper()}"
                f"{'+LES' if spec.smagorinsky_cs else ''}"
                f"{'+' + spec.rheology['model'] if spec.rheology else ''} "
                f"{args.case} {dims} fp32, "
                f"{chips})",
                "value": round(mlups, 1),
                "unit": "MLUPS",
                "vs_baseline": round(mlups / BASELINE_MLUPS, 2),
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
