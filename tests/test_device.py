"""The platform decision, the GPU gate and the compile-cache rule
(lbm_jax/device.py), and the entry points that refuse a CPU device."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from lbm_jax.cases import get_case
from lbm_jax.device import (BACKENDS, device_info, require_gpu,
                            resolve_backend, setup_compile_cache)
from lbm_jax.engine.runner import Simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend,expected", [
    ("auto", "xla"), ("xla", "xla"), ("sparse", "sparse")])
def test_resolve_backend(backend, expected):
    assert resolve_backend(backend) == expected


@pytest.mark.parametrize("backend", ["cuda", "gpu", ""])
def test_resolve_backend_refuses_unknown(backend):
    with pytest.raises(ValueError, match="backend must be"):
        resolve_backend(backend)


def test_simulation_auto_backend_is_dense():
    sim = Simulation(get_case("lid_driven_cavity", n=8))
    assert sim.backend == "xla" and set(BACKENDS) == {"xla", "sparse"}


def test_device_info_names_the_device():
    info = device_info()
    assert info == {"platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache(root="/nonexistent") == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = setup_compile_cache(root=str(tmp_path))
        assert path == os.path.join(str(tmp_path), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the default root is the checkout itself, the same every call
        assert setup_compile_cache() == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(argv, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + argv, capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=300)


def _json_lines(text):
    out = []
    for ln in text.splitlines():
        try:
            out.append(json.loads(ln))
        except json.JSONDecodeError:
            pass
    return out


def test_bench_refuses_cpu():
    r = _run(["bench.py", "--n", "8", "--steps", "2"], REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _json_lines(r.stdout) == []


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert not any(d.get("ok") for d in _json_lines(r.stdout))


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not any(d.get("ok") for d in _json_lines(r.stdout))


def test_checkpoint_refuses_packed_layout(tmp_path):
    from lbm_jax.engine import checkpoint as ckpt

    spec = get_case("lid_driven_cavity", n=8)
    sim = Simulation(spec)
    path = str(tmp_path / "packed.npz")
    ckpt.save(path, np.zeros((10, 10, 24, 8), np.float32), 5, spec.name,
              {"layout": {"packed": True, "ring": 1}})
    with pytest.raises(ValueError, match="portable"):
        ckpt.restore(sim, path)
