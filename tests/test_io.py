"""IO tests: VTK format parity, convergence log, snapshots, checkpoint
round-trip, CLI end-to-end."""

import os
import subprocess
import sys

import numpy as np

from lbm_jax.cases import get_case
from lbm_jax.engine import checkpoint as ckpt
from lbm_jax.engine.runner import Simulation
from lbm_jax.io.vtk import case_vtk, write_structured_points
from lbm_jax.io.snapshots import write_bc_csv, write_midplane


def test_vtk_ascii_format(tmp_path):
    rho = np.ones((8, 8, 8), np.float32)
    u = np.zeros((3, 8, 8, 8), np.float32)
    u[2, 4, 4, 4] = 1.25
    path = tmp_path / "t.vtk"
    write_structured_points(
        str(path), {"VELOCITY": u, "DENSITY": rho},
        spacing=0.5, origin=(1.0, 2.0, 0.0), crops=(2, 2, 2),
    )
    text = path.read_text()
    assert "DATASET STRUCTURED_POINTS" in text
    assert "DIMENSIONS 4 4 4" in text
    assert "POINT_DATA  64" in text
    assert "VECTORS VELOCITY float" in text
    assert "SCALARS DENSITY float" in text
    assert "1.25" in text


def test_vtk_binary_roundtrip(tmp_path):
    u = np.arange(3 * 4 * 4 * 4, dtype=np.float32).reshape(3, 4, 4, 4)
    path = tmp_path / "b.vtk"
    write_structured_points(
        str(path), {"VELOCITY": u}, spacing=1.0, origin=(0, 0, 0), binary=True
    )
    raw = path.read_bytes()
    header_end = raw.index(b"VECTORS VELOCITY float\n") + len(
        b"VECTORS VELOCITY float\n"
    )
    vals = np.frombuffer(raw[header_end : header_end + 4 * 3 * 64], ">f4")
    # x-fastest with xyz components inner.
    assert vals[0] == u[0, 0, 0, 0] and vals[1] == u[1, 0, 0, 0]
    assert vals[3] == u[0, 1, 0, 0]


def test_case_vtk_and_snapshots(tmp_path):
    sim = Simulation(get_case("lid_driven_cavity", n=16))
    sim.run(max_steps=10, time_save=10, verbose=False)
    path = case_vtk(sim, str(tmp_path), sim.t)
    assert os.path.exists(path)
    text = open(path).read()
    assert "DIMENSIONS 12 12 12" in text
    rho, u = sim.macro()
    write_midplane(str(tmp_path / "meas1.txt"), u)
    assert len(open(tmp_path / "meas1.txt").read().split()) == 2 * 16 * 16
    write_bc_csv(str(tmp_path / "vel.csv"), u, sim.spec.mask)
    lines = open(tmp_path / "vel.csv").read().strip().splitlines()
    assert len(lines) == int((np.asarray(sim.spec.mask) == 2).sum())
    assert lines[0].count(",") == 5


def test_checkpoint_roundtrip(tmp_path):
    sim = Simulation(get_case("lid_driven_cavity", n=16))
    sim.run(max_steps=20, time_save=10, verbose=False)
    p = str(tmp_path / "c.npz")
    ckpt.save(p, sim.f, sim.t, sim.spec.name)
    f_before = np.asarray(sim.f).copy()
    t_before = sim.t

    sim2 = Simulation(get_case("lid_driven_cavity", n=16))
    ckpt.restore(sim2, p)
    assert sim2.t == t_before
    np.testing.assert_array_equal(np.asarray(sim2.f), f_before)

    # Resumed run must continue identically to an uninterrupted one.
    sim.run(max_steps=10, time_save=10, verbose=False)
    sim2.run(max_steps=10, time_save=10, verbose=False)
    np.testing.assert_array_equal(np.asarray(sim.f), np.asarray(sim2.f))


def test_checkpoint_rejects_wrong_case(tmp_path):
    sim = Simulation(get_case("lid_driven_cavity", n=16))
    p = str(tmp_path / "c.npz")
    ckpt.save(p, sim.f, 0, "someother")
    import pytest

    with pytest.raises(ValueError):
        ckpt.restore(sim, p)


def test_cli_end_to_end(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "lbm_jax", "run", "--case", "lid_driven_cavity",
         "--out", str(out), "--steps", "20", "--time-save", "10",
         "--checkpoint-every", "1", "--opt", "n=16"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "TOTAL RUNNING TIME" in r.stdout
    assert (out / "CONVERGENCE.log").exists()
    assert (out / "lid_driven_cavity.ckpt.npz").exists()
    vtks = list(out.glob("*.vtk"))
    assert len(vtks) >= 2
    assert "MLUPS" in r.stdout


def test_cli_list():
    r = subprocess.run(
        [sys.executable, "-m", "lbm_jax", "list"],
        capture_output=True, text=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0
    for name in ["lid_driven_cavity", "poiseuille", "bifurcation",
                 "curved_vessel", "coronary"]:
        assert name in r.stdout


def test_cli_snapshots(tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "lbm_jax", "run", "--case", "lid_driven_cavity",
         "--out", str(out), "--steps", "10", "--time-save", "10",
         "--no-vtk", "--snapshots", "--backend", "xla", "--opt", "n=16"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    for fn in ("meas1.txt", "s1_out.txt", "vel.csv"):
        assert (out / fn).exists(), fn
    assert len((out / "meas1.txt").read_text().split()) == 2 * 16 * 16


def test_cli_vtk_final(tmp_path):
    """--vtk-final suppresses per-save VTK and writes exactly one file
    at the last step (the large-grid runs' mode: per-save VTK on a
    31M-cell grid dominates wall time)."""
    out = tmp_path / "out"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "lbm_jax", "run", "--case",
         "lid_driven_cavity", "--out", str(out), "--steps", "10",
         "--time-save", "5", "--vtk-final", "--backend", "xla",
         "--opt", "n=16"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    vtks = sorted(out.glob("*.vtk"))
    assert [v.name for v in vtks] == ["lid_driven_cavity_10.vtk"]
    assert (out / "CONVERGENCE.log").exists()  # residuals still per save


def test_write_live_velocities(tmp_path):
    from lbm_jax.io.snapshots import write_live_velocities

    sim = Simulation(get_case("lid_driven_cavity", n=8))
    rho, u = sim.macro()
    p = tmp_path / "scenario.txt"
    write_live_velocities(str(p), u, sim.spec.mask)
    lines = p.read_text().splitlines()
    assert len(lines) == 8  # one per z slab (dead slabs are blank)
    n_live = [int((np.asarray(sim.spec.mask)[:, :, z] != 0).sum())
              for z in range(8)]
    for z in (0, 3, 7):
        assert len(lines[z].split()) == 3 * n_live[z]


def test_midplane_ingest_roundtrip(tmp_path):
    """read_midplane inverts write_midplane_fluid (the reference's
    measured-data ingest, bifurcation.cu:255-291) and compare_midplane
    reports zero error against the run it came from."""
    from lbm_jax.geometry.mask import CellType
    from lbm_jax.io.snapshots import (
        compare_midplane,
        read_midplane,
        write_midplane_fluid,
    )

    sim = Simulation(get_case("lid_driven_cavity", n=8))
    sim.f, _, _ = sim._chunk(20)(sim.f, np.int32(0))
    rho, u = sim.macro()
    u = np.asarray(u)
    mask = np.asarray(sim.spec.mask)
    p = tmp_path / "meas1.txt"
    write_midplane_fluid(str(p), u, mask)
    planes = read_midplane(str(p), u.shape[1:3], mask=mask)
    fl = mask[:, :, mask.shape[2] // 2] == CellType.FLUID
    # write_midplane_fluid writes (uy, ux); %g costs ~6 digits
    np.testing.assert_allclose(
        planes[0][fl], u[1][:, :, u.shape[3] // 2][fl],
        rtol=2e-5, atol=1e-12)
    stats = compare_midplane(
        planes, np.stack([np.where(fl, u[1][:, :, u.shape[3] // 2], 0.0),
                          np.where(fl, u[0][:, :, u.shape[3] // 2], 0.0)]),
        fluid=fl)
    assert stats["l2_rel"] < 1e-4 and stats["corr"] > 0.999
    # a perturbed "measurement" must register a nonzero error
    stats2 = compare_midplane(planes * 1.1, planes, fluid=fl)
    assert 0.05 < stats2["l2_rel"] < 0.2
