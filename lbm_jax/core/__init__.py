from lbm_jax.core.lattice import D3Q19, feq, phi, moments
from lbm_jax.core.units import UnitSystem

__all__ = ["D3Q19", "feq", "phi", "moments", "UnitSystem"]
