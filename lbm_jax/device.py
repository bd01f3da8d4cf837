"""Where the program runs: the step backend, the device check, and the
persistent compilation cache.

Every platform decision of the package is made here, once.
"""

from __future__ import annotations

import os

BACKENDS = ("xla", "sparse")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def resolve_backend(backend: str) -> str:
    """The step backend a Simulation uses. 'auto' is the dense XLA step
    on every platform; 'sparse' (the compacted live-cell gather) is
    chosen explicitly."""
    if backend == "auto":
        return "xla"
    if backend not in BACKENDS:
        raise ValueError(
            f"backend must be 'auto' or one of {BACKENDS}, got {backend!r}")
    return backend


def device_info() -> dict:
    """{"platform", "kind", "count"} of the devices JAX sees."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or RuntimeError when JAX's first device is not a
    GPU. Measurement paths call this so that a run on the CPU never
    reports its numbers as device numbers."""
    info = device_info()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU found: JAX's first device is {info['platform']!r} "
            f"({info['kind']})")
    return info


def setup_compile_cache(root: str | None = None) -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. When JAX_COMPILATION_CACHE_DIR is set, JAX reads it
    itself and nothing is set here; otherwise the cache lives at the
    fixed path <root>/.jax_cache (root defaults to the checkout holding
    this package). The path is part of the cache key, so it never
    depends on a PID, a time or a temporary name."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(root or _REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


__all__ = ["BACKENDS", "resolve_backend", "device_info", "require_gpu",
           "setup_compile_cache"]
