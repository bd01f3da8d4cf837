from lbm_jax.geometry.mask import (
    CellType,
    erode_label,
    end_plane_min_label,
    end_plane_copy_label,
    ghost_dilate,
    compact_index,
)
from lbm_jax.geometry import shapes, io

__all__ = [
    "CellType",
    "erode_label",
    "end_plane_min_label",
    "end_plane_copy_label",
    "ghost_dilate",
    "compact_index",
    "shapes",
    "io",
]
