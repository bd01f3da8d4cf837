"""Checkpoint / resume — a capability the reference lacks entirely
(SURVEY.md section 5: "a crashed run restarts from step 0"; pdfs are never
saved). State = (f, t, convergence window) plus case identity; npz on
disk, via a temp-file rename for crash atomicity.

The on-disk layout is the unpadded (19, nx, ny, nz) f, which transfers
between backends (xla <-> sparse) and shardings.
"""

from __future__ import annotations

import json
import os

import numpy as np


def save(path: str, f, t: int, case_name: str, meta: dict | None = None,
         compressed: bool = True) -> None:
    tmp = path + ".tmp"
    saver = np.savez_compressed if compressed else np.savez
    saver(
        tmp,
        f=np.asarray(f),
        t=np.int64(t),
        case=np.bytes_(case_name.encode()),
        meta=np.bytes_(json.dumps(meta or {}).encode()),
    )
    # np.savez appends .npz to names lacking it.
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def save_sim(path: str, sim, meta: dict | None = None) -> None:
    """Checkpoint a Simulation including its convergence state, so the
    first post-resume residual is computed against the pre-crash window
    instead of from scratch (a resumed run must not report a spurious
    'converged' or reset residual)."""
    m = dict(meta or {})
    m["conv"] = {
        "last_velsum": sim._last_velsum,
        "last_usq": sim._last_usq,
    }
    if getattr(sim, "wk", None) is not None:
        # windkessel per-outlet P_c carry (spec.PlaneBC.windkessel)
        m["wk"] = [float(v) for v in np.asarray(sim.wk)]
    save(path, sim.f_standard(), sim.t, sim.spec.name, m)


def load(path: str):
    with np.load(path) as data:
        f = data["f"]
        t = int(data["t"])
        case = bytes(data["case"]).decode()
        meta = json.loads(bytes(data["meta"]).decode())
    return f, t, case, meta


def restore(sim, path: str) -> None:
    """Restore a Simulation in place, verifying case identity. The
    checkpoint holds the unpadded (19, nx, ny, nz) layout and restores
    into any backend/sharding."""
    f, t, case, meta = load(path)
    if case != sim.spec.name:
        raise ValueError(
            f"checkpoint is for case {case!r}, simulation is {sim.spec.name!r}"
        )
    if (meta.get("layout") or {}).get("packed"):
        raise ValueError(
            f"{path} holds a packed channel-major state written by the "
            "removed packed-kernel backend; this version reads only the "
            "portable (19, nx, ny, nz) layout — rewrite the checkpoint "
            "from a version that still has that backend")
    if f.shape != (19,) + tuple(sim.spec.shape):
        raise ValueError(
            f"checkpoint shape {f.shape} != case {sim.spec.shape}")
    sim.set_f_standard(f)
    sim.t = t
    conv = meta.get("conv", {})
    sim._last_velsum = conv.get("last_velsum")
    sim._last_usq = conv.get("last_usq")
    if meta.get("wk") is not None:
        if getattr(sim, "wk", None) is None:
            raise ValueError(
                "checkpoint carries windkessel state but the target "
                "case has no windkessel outlets"
            )
        import jax.numpy as jnp

        sim.wk = jnp.asarray(meta["wk"], jnp.float32)


__all__ = ["save", "save_sim", "load", "restore"]
