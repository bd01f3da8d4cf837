"""Case registry: the reference's five simulation programs as configs."""

from __future__ import annotations

from typing import Callable

from lbm_jax.engine.spec import CaseSpec

_REGISTRY: dict[str, Callable[..., CaseSpec]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_case(name: str, **kwargs) -> CaseSpec:
    # Import for side effects (registration) lazily to avoid cycles.
    from lbm_jax.cases import (  # noqa: F401
        bifurcation,
        coronary,
        curved_vessel,
        gravity_channel,
        lid_driven_cavity,
        pipe,
        poiseuille,
    )

    if name not in _REGISTRY:
        raise KeyError(f"unknown case {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def list_cases() -> list[str]:
    from lbm_jax.cases import (  # noqa: F401
        bifurcation,
        coronary,
        curved_vessel,
        gravity_channel,
        lid_driven_cavity,
        pipe,
        poiseuille,
    )

    return sorted(_REGISTRY)


__all__ = ["register", "get_case", "list_cases"]
