"""Surface reconstruction from scattered point clouds.

The reference's offline pipeline starts from ultrasound-segmented point
clouds triangulated by MyCrustOpen (MyCrustOpen/MyCrustOpen.m, a
crust-style method; SURVEY.md §2.3), then smoothed (smoothpatch) and
voxelized. This module provides the equivalent capability with a robust
volumetric route that matches what the LBM pipeline actually consumes:

  points -> solid occupancy  (rasterize + morphological close + fill)
         -> boundary mesh    (exposed voxel faces, shared vertices)
         -> smooth surface   (geometry/native.smooth_mesh curvature flow)

plus a classic alpha-shape crust (Edelsbrunner) for volumetric samples.
Surface-only clouds of globally co-spherical/cylindrical shape are
degenerate for alpha shapes; the volumetric route handles them.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Volumetric route
# ---------------------------------------------------------------------------

def cloud_to_occupancy(
    points: np.ndarray,
    shape: tuple[int, int, int],
    margin: int = 3,
    close_iters: int | None = None,
):
    """Rasterize a surface point cloud to a SOLID binary occupancy grid:
    mark point voxels, dilate enough to seal the inter-sample gaps, fill
    the interior, erode back. Returns (occ (shape) int32, origin,
    spacing). close_iters defaults to the gap size implied by the
    cloud's median point spacing."""
    import scipy.ndimage as ndi

    pts = np.asarray(points, np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    spacing = float(np.max((hi - lo) / (np.asarray(shape) - 2 * margin)))
    center = (lo + hi) / 2
    origin = center - np.asarray(shape) * spacing / 2
    ijk = np.floor((pts - origin) / spacing).astype(int)
    ijk = np.clip(ijk, 0, np.asarray(shape) - 1)
    occ = np.zeros(shape, bool)
    occ[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    st = ndi.generate_binary_structure(3, 3)  # 26-connected: seals diagonals
    if close_iters is not None:
        ks = [close_iters]
    else:
        k0 = max(1, int(np.ceil(median_spacing(pts) / spacing)))
        ks = list(range(k0, k0 + 6))
    def fill_2d(dil):
        """Per-slice 2D fills along each axis, merged — handles OPEN
        tubular surfaces (vessel segments) whose interior leaks through
        the end openings in 3D."""
        out = dil.copy()
        for axis in range(3):
            for s in range(dil.shape[axis]):
                sl = [slice(None)] * 3
                sl[axis] = s
                out[tuple(sl)] |= ndi.binary_fill_holes(dil[tuple(sl)])
        return out

    def accept(filled, dil):
        return close_iters is not None or (
            filled.sum() - dil.sum() > 0.005 * filled.size
        )

    dils = {
        k: ndi.binary_dilation(occ, structure=st, iterations=k) for k in ks
    }
    # Prefer a full 3D fill at any closing radius over partial 2D fills.
    for filler in (ndi.binary_fill_holes, fill_2d):
        for k in ks:
            filled = filler(dils[k])
            if accept(filled, dils[k]):
                out = ndi.binary_erosion(filled, structure=st, iterations=k)
                return out.astype(np.int32), origin, spacing
    raise ValueError(
        "could not seal the point-cloud shell; increase grid resolution "
        "or pass close_iters explicitly"
    )


def voxel_boundary_mesh(
    occ: np.ndarray, origin=(0.0, 0.0, 0.0), spacing: float = 1.0
):
    """Triangle mesh of the exposed voxel faces (two triangles per face,
    shared corner vertices). Blocky by construction — feed it through
    smooth_mesh(mode='curvature') for a smooth surface, exactly the role
    the reference's smoothpatch plays after voxel segmentation."""
    occ = np.asarray(occ).astype(bool)
    nx, ny, nz = occ.shape
    corners: dict[tuple[int, int, int], int] = {}
    verts: list[tuple[int, int, int]] = []
    faces: list[list[int]] = []

    def vid(c):
        if c not in corners:
            corners[c] = len(verts)
            verts.append(c)
        return corners[c]

    pad = np.pad(occ, 1)
    # For each axis and direction, exposed faces = occ & ~shifted(occ).
    for axis in range(3):
        for sgn in (1, -1):
            shifted = np.roll(pad, -sgn, axis=axis)
            exposed = pad & ~shifted
            cells = np.argwhere(exposed) - 1
            for x, y, z in cells:
                # The face of cell (x,y,z) facing +/-axis: its 4 corners.
                base = [x, y, z]
                base[axis] += (sgn + 1) // 2
                a1, a2 = [a for a in range(3) if a != axis]
                quad = []
                for d1, d2 in ((0, 0), (1, 0), (1, 1), (0, 1)):
                    c = list(base)
                    c[a1] += d1
                    c[a2] += d2
                    quad.append(vid(tuple(c)))
                if sgn > 0:
                    faces.append([quad[0], quad[1], quad[2]])
                    faces.append([quad[0], quad[2], quad[3]])
                else:
                    faces.append([quad[0], quad[2], quad[1]])
                    faces.append([quad[0], quad[3], quad[2]])

    v = np.asarray(verts, np.float64) * spacing + np.asarray(origin)
    return v, np.asarray(faces, np.int64)


def reconstruct_surface(
    points: np.ndarray,
    shape: tuple[int, int, int] = (64, 64, 64),
    smooth_iters: int = 8,
):
    """Full MyCrustOpen-equivalent: cloud -> smooth triangle surface."""
    from lbm_jax.geometry.native import smooth_mesh

    occ, origin, spacing = cloud_to_occupancy(points, shape)
    verts, faces = voxel_boundary_mesh(occ, origin, spacing)
    if smooth_iters:
        verts = smooth_mesh(verts, faces, iterations=smooth_iters,
                            mode="curvature")
    return verts, faces


# ---------------------------------------------------------------------------
# Ball-pivoting crust (surface samples, incl. thin OPEN shells)
# ---------------------------------------------------------------------------

def _ball_centers(p0, p1, p2, r):
    """Both centers of a radius-r ball touching the three points, or None
    if their circumradius exceeds r (ball falls through the triangle)."""
    b, c = p1 - p0, p2 - p0
    n = np.cross(b, c)
    nn = float(n @ n)
    if nn < 1e-24:
        return None
    # circumcenter in the triangle plane (relative to p0)
    cc = (np.cross((b @ b) * c - (c @ c) * b, n)) / (2.0 * nn)
    h2 = r * r - float(cc @ cc)
    if h2 <= 0.0:
        return None
    h = np.sqrt(h2) / np.sqrt(nn)
    return p0 + cc + n * h, p0 + cc - n * h


def ball_pivot_surface(
    points: np.ndarray, radius=None
) -> tuple[np.ndarray, np.ndarray]:
    """Ball-pivoting triangulation of a SURFACE point cloud (Bernardini
    et al.): a radius-r ball pivots around each front edge onto the next
    sample point. Unlike the volumetric route (cloud_to_occupancy), this
    reconstructs thin OPEN shells faithfully — the capability class of
    the reference's MyCrustOpen crust triangulation (MyCrustOpen.m,
    SURVEY §2.3) that rasterize+fill cannot cover (an open shell has no
    interior to fill).

    radius: a float, a sequence of floats (multi-scale BPA: boundary
    edges left by one radius are re-pivoted with the next, filling
    undersampled gaps without losing fine detail), or None for the
    classic default (1.3, 2.0, 3.0)x the median nearest-neighbor
    spacing. Returns (verts, faces) with verts == the input points
    (unused points dropped), faces (m, 3) int64.

    Caveat (inherent to BPA): EXACTLY regular lattice samplings put 4+
    points on one pivot circumsphere and the tie-broken sheets do not
    glue; any irregularity (real scans, or ~1e-3 jitter) resolves it.
    """
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    npts = len(pts)
    if radius is None:
        med = median_spacing(pts)
        radii = [1.3 * med, 2.0 * med, 3.0 * med]
    elif np.ndim(radius) == 0:
        radii = [float(radius)]
    else:
        radii = [float(v) for v in radius]
    r = radii[0]
    tree = cKDTree(pts)

    faces: list[tuple[int, int, int]] = []
    # Each triangle (a, b, c) CONSUMES directed edges a->b, b->c, c->a
    # and OFFERS the reversed ones to the front, so an undirected edge
    # joins at most two (consistently oriented) triangles — the manifold
    # invariant. A front edge whose pivot finds nothing is a boundary
    # edge (open shells have them); it goes to `dead`, not `consumed`.
    front: dict[tuple[int, int], np.ndarray] = {}
    consumed: set[tuple[int, int]] = set()
    dead: dict[tuple[int, int], np.ndarray] = {}
    in_mesh = np.zeros(npts, bool)

    def empty(center, tri):
        idx = tree.query_ball_point(center, r * (1.0 - 1e-9))
        return all(i in tri for i in idx)

    def seed(start):
        """Find one empty-ball triangle among start's neighborhood.
        Only unused points participate — a seed touching meshed points
        could re-consume their directed edges (non-manifold)."""
        nbrs = tree.query_ball_point(pts[start], 2.0 * r)
        nbrs = [i for i in nbrs if i != start and not in_mesh[i]]
        nbrs.sort(key=lambda i: float(np.sum((pts[i] - pts[start]) ** 2)))
        for ia in range(len(nbrs)):
            for ib in range(ia + 1, len(nbrs)):
                a, b = nbrs[ia], nbrs[ib]
                cs = _ball_centers(pts[start], pts[a], pts[b], r)
                if cs is None:
                    continue
                for o in cs:
                    if empty(o, {start, a, b}):
                        return (start, a, b), o
        return None, None

    def pivot(a, b, o_old):
        """Pivot the ball around edge (a, b) from center o_old; return
        (point, new_center) of the smallest-angle touch, or None."""
        pa, pb = pts[a], pts[b]
        axis = pb - pa
        axis = axis / np.linalg.norm(axis)
        m = (pa + pb) / 2.0
        v_old = o_old - m
        v_old = v_old - (v_old @ axis) * axis
        nv = np.linalg.norm(v_old)
        if nv < 1e-12:
            return None
        v_old /= nv
        # rolling sense: the ball rolls over the directed front edge
        # (a, b) AWAY from its minting triangle — for our CCW edge
        # convention that is a NEGATIVE rotation around (pb - pa)
        # (measured: +axis sense folds sheets back over the surface —
        # sphere got 3342 faces/1170 boundary edges vs the exact
        # 2V-4 = 3196/0 with this sense)
        w = np.cross(v_old, axis)
        best, best_t, best_o = None, np.inf, None
        # any touched point c satisfies |c - m| <= |c - o| + |o - m|
        #                              = r + sqrt(r^2 - |pa - m|^2)
        d2 = float(np.sum((pa - m) ** 2))
        reach = r + np.sqrt(max(r * r - d2, 0.0))
        for c in tree.query_ball_point(m, reach):
            if c == a or c == b:
                continue
            cs = _ball_centers(pa, pb, pts[c], r)
            if cs is None:
                continue
            for o in cs:
                v = o - m
                v = v - (v @ axis) * axis
                nvv = np.linalg.norm(v)
                if nvv < 1e-12:
                    continue
                v = v / nvv
                # rotation angle of the center from v_old, in (0, 2pi):
                # the first point the rolling ball touches wins
                ang = np.arctan2(float(v @ w), float(v @ v_old))
                if ang < 1e-9:
                    ang += 2.0 * np.pi
                if ang < best_t:
                    best, best_t, best_o = c, ang, o
        return (best, best_o) if best is not None else None

    def add_tri(a, b, c, o):
        faces.append((a, b, c))
        in_mesh[[a, b, c]] = True
        for e in ((a, b), (b, c), (c, a)):
            consumed.add(e)
            front.pop(e, None)
            dead.pop(e, None)
        for e in ((b, a), (c, b), (a, c)):
            if e not in consumed and e not in front:
                front[e] = o

    def drain():
        while front:
            (a, b), o_old = next(iter(front.items()))
            front.pop((a, b))
            hit = pivot(a, b, o_old)
            if hit is None:
                dead[(a, b)] = o_old
                continue
            c, o_new = hit
            # manifold guard: every directed edge at most one triangle
            if ((b, c) in consumed or (c, a) in consumed
                    or (a, b) in consumed):
                dead[(a, b)] = o_old
                continue
            add_tri(a, b, c, o_new)

    order = np.argsort(pts[:, 0], kind="stable")
    for rk in radii:
        r = rk
        # boundary edges of the previous (smaller) radius get another
        # chance with the bigger ball (multi-scale BPA)
        for e, o in list(dead.items()):
            if e not in consumed:
                front[e] = o
        dead.clear()
        drain()
        for s in order:
            if in_mesh[s]:
                continue
            tri, o = seed(int(s))
            if tri is None:
                continue
            add_tri(*tri, o)
            drain()

    if not faces:
        raise ValueError(
            "ball_pivot_surface: no seed triangle found — radius too "
            "small for the sampling density (try a larger radius)"
        )
    f = np.asarray(faces, np.int64)
    used = np.unique(f)
    remap = -np.ones(npts, np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[f]


# ---------------------------------------------------------------------------
# Alpha-shape crust (volumetric samples)
# ---------------------------------------------------------------------------

def _circumradii(points: np.ndarray, tets: np.ndarray) -> np.ndarray:
    a = points[tets[:, 0]]
    b = points[tets[:, 1]] - a
    c = points[tets[:, 2]] - a
    d = points[tets[:, 3]] - a
    bb = np.sum(b * b, axis=1)
    cc = np.sum(c * c, axis=1)
    dd = np.sum(d * d, axis=1)
    cross_cd = np.cross(c, d)
    cross_db = np.cross(d, b)
    cross_bc = np.cross(b, c)
    denom = 2.0 * np.sum(b * cross_cd, axis=1)
    small = np.abs(denom) < 1e-30
    denom = np.where(small, 1.0, denom)
    o = (
        bb[:, None] * cross_cd + cc[:, None] * cross_db
        + dd[:, None] * cross_bc
    ) / denom[:, None]
    r = np.linalg.norm(o, axis=1)
    return np.where(small, np.inf, r)


def median_spacing(points: np.ndarray, sample: int = 512) -> float:
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    tree = cKDTree(pts)
    idx = np.random.default_rng(0).choice(
        len(pts), size=min(sample, len(pts)), replace=False
    )
    d, _ = tree.query(pts[idx], k=2)
    return float(np.median(d[:, 1]))


def alpha_shape_surface(
    points: np.ndarray, alpha: float | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Alpha-shape boundary mesh of a VOLUMETRIC sample (n, 3): keep
    Delaunay tetrahedra with circumradius <= alpha, emit faces belonging
    to exactly one kept tet."""
    from scipy.spatial import Delaunay

    pts = np.asarray(points, np.float64)
    if alpha is None:
        alpha = 2.5 * median_spacing(pts)
    tri = Delaunay(pts)
    tets = tri.simplices
    keep = tets[_circumradii(pts, tets) <= alpha]
    if len(keep) == 0:
        raise ValueError("alpha too small: no tetrahedra kept")
    faces = np.concatenate(
        [keep[:, [0, 1, 2]], keep[:, [0, 1, 3]],
         keep[:, [0, 2, 3]], keep[:, [1, 2, 3]]]
    )
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    boundary = faces[counts[inv] == 1]
    used = np.unique(boundary)
    remap = -np.ones(len(pts), np.int64)
    remap[used] = np.arange(len(used))
    return pts[used], remap[boundary]


__all__ = [
    "cloud_to_occupancy",
    "voxel_boundary_mesh",
    "reconstruct_surface",
    "ball_pivot_surface",
    "alpha_shape_surface",
    "median_spacing",
]


def load_point_cloud_mat(path: str, var: str = "p") -> np.ndarray:
    """Load a MATLAB point cloud (the MyCrustOpen demo .mat format:
    variable `p`, (n, 3) doubles — MyCrustOpen/TestMyCrustOpen.m)."""
    from scipy.io import loadmat

    d = loadmat(path)
    if var not in d:
        cand = [k for k in d if not k.startswith("__")]
        raise KeyError(f"variable {var!r} not in {path} (has {cand})")
    pts = np.asarray(d[var], np.float64)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"{path}:{var} is {pts.shape}, expected (n, 3)")
    return pts
