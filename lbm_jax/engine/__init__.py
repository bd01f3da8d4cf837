from lbm_jax.engine.spec import CaseSpec, PlaneBC
from lbm_jax.engine.compile import CompiledCase, compile_case
from lbm_jax.engine.step import make_step, initial_f
from lbm_jax.engine.runner import Simulation, RunResult
from lbm_jax.engine.scalar import ScalarTransport, CoupledTransport
from lbm_jax.engine.thermal import BuoyantTransport

__all__ = [
    "CaseSpec",
    "PlaneBC",
    "CompiledCase",
    "compile_case",
    "make_step",
    "initial_f",
    "Simulation",
    "RunResult",
    "ScalarTransport",
    "CoupledTransport",
    "BuoyantTransport",
]
