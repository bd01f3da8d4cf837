from lbm_jax.io.vtk import write_structured_points, case_vtk
from lbm_jax.io.convlog import ConvergenceLog
from lbm_jax.io import snapshots

__all__ = [
    "write_structured_points",
    "case_vtk",
    "ConvergenceLog",
    "snapshots",
]
