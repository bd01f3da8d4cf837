"""lbm_jax — a JAX D3Q19 BGK Lattice-Boltzmann CFD framework.

Built from scratch in JAX/XLA with the capabilities of the CUDA
reference `Xinhuan-Imperial/Lattice-Boltzmann-Method-GPU` (see SURVEY.md):
steady and unsteady 3D single-phase Newtonian flow on uniform Cartesian
grids, 6-valued cell masks, half-way bounce-back walls, non-equilibrium
extrapolation (NEE) velocity/pressure inlets and outlets, residual-based
convergence, physical-unit VTK output, checkpoint/resume, and spatial
domain decomposition over a device mesh.

Top-level convenience re-exports; see subpackages for detail:
  core      — D3Q19 lattice constants, equilibrium, moments, unit system
  geometry  — mask labeling (erosion/ghost/compaction), shapes, file IO
  engine    — case specs, compiled cases, the fused step, the runner
  parallel  — device-mesh sharding (GSPMD + explicit halo exchange)
  device    — backend choice, GPU check, persistent compile cache
  cases     — the five reference cases as declarative configs
  io        — VTK writer, convergence log, snapshot writers
"""

from lbm_jax.core.lattice import D3Q19
from lbm_jax.core.units import UnitSystem

__version__ = "0.1.0"

__all__ = ["D3Q19", "UnitSystem", "__version__"]
