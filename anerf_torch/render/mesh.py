"""Mesh extraction and headless mesh rendering.

Port of ``anerf_tpu/render/mesh.py``, which replaces the reference's
mcubes + trimesh + OpenGL viewer stack (run_render.py:970-986
``render_mesh``, render_mesh.py, render/):
  * density is evaluated on a (res+1)^3 grid centered at the root joint
    by the raycaster's density-only forward on the device the
    parameters live on (reference RayCaster.render_mesh_density,
    raycasters.py:579-595);
  * the isosurface is extracted with marching *tetrahedra*, table-free
    and exact on the same density field (the reference uses marching
    cubes: the triangulation differs, the surface does not);
  * meshes are written as PLY (replacing trimesh);
  * turntables are drawn by a small numpy z-buffer rasterizer with
    normal-based coloring (replacing the EGL/GLSL viewer of
    render/color_render.py).
Everything after the density grid is host numpy, copied from anerf_tpu.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Six tetrahedra per cube (corner indices in binary zyx order: bit0=x,
# bit1=y, bit2=z), all sharing the 0-7 diagonal.
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], np.int64)

_CORNERS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                     for x in (0, 1)], np.int64)  # bit0=x,bit1=y,bit2=z
_CORNERS = _CORNERS[:, [0, 1, 2]]


def extract_density_grid(rc, params, pose, radius: float = 1.0,
                         res: int = 64, chunk: int = 65536,
                         state=None) -> np.ndarray:
    """Raw density on a (res+1)^3 grid centered at the root keypoint
    (reference render_mesh_density, raycasters.py:579-595: meshgrid of
    np.linspace over [-radius, radius], xy-indexing).  ``params`` and the
    ``pose`` tensors (kps (1, J, 3), skts (1, J, 4, 4), bones) sit on
    the device that evaluates the grid, in chunks of ``chunk`` points;
    the result comes back to the host once."""
    from ..models.raycaster import render_pts_density

    t = np.linspace(-radius, radius, res + 1, dtype=np.float32)
    grid = np.stack(np.meshgrid(t, t, t), axis=-1).reshape(-1, 3)
    center = pose['kps'][0, 0].detach().cpu().numpy()
    pts = grid + center
    n = pts.shape[0]
    pad = (n + chunk - 1) // chunk * chunk - n
    pts_p = torch.as_tensor(
        np.concatenate([pts, np.zeros((pad, 3), np.float32)], 0),
        device=pose['kps'].device)
    with torch.inference_mode():
        sigma = torch.cat([
            render_pts_density(rc, params, pts_p[s:s + chunk, None], pose,
                               state)[:, 0, 0]
            for s in range(0, len(pts_p), chunk)])
    return sigma[:n].float().cpu().numpy().reshape(res + 1, res + 1, res + 1)


def marching_tetrahedra(sigma: np.ndarray, threshold: float = 10.,
                        origin: Optional[np.ndarray] = None,
                        spacing: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a scalar grid via marching tetrahedra (vectorized).

    Returns (verts (V, 3), faces (F, 3)).  Vertex positions are in grid
    units scaled by ``spacing`` and offset by ``origin``.
    """
    G = np.asarray(sigma, np.float64)
    nx, ny, nz = G.shape
    # cell corner values: (cx, cy, cz, 8)
    base = np.stack(np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                                np.arange(nz - 1), indexing='ij'),
                    axis=-1).reshape(-1, 3)
    corner_vals = np.stack(
        [G[base[:, 0] + c[0], base[:, 1] + c[1], base[:, 2] + c[2]]
         for c in _CORNERS], axis=-1)          # (C, 8)
    corner_pos = (base[:, None, :] + _CORNERS[None]).astype(np.float64)

    # quick reject: cells fully in/out
    occ = corner_vals > threshold
    active = np.where(occ.any(-1) & (~occ.all(-1)))[0]
    if len(active) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    cv = corner_vals[active]
    cp = corner_pos[active]

    tris = []
    for tet in _TETS:
        v = cv[:, tet]                     # (C, 4)
        p = cp[:, tet]                     # (C, 4, 3)
        inside = v > threshold             # (C, 4)
        n_in = inside.sum(-1)

        def edge_point(pa, pb, va, vb):
            t = (threshold - va) / np.where(vb - va == 0, 1e-12, vb - va)
            return pa + t[:, None] * (pb - pa)

        # case: exactly one corner inside -> 1 triangle
        for which, flip in ((1, False), (3, True)):
            sel = np.where(n_in == which)[0]
            if len(sel) == 0:
                continue
            ins = inside[sel] if which == 1 else ~inside[sel]
            apex = np.argmax(ins, axis=-1)
            others = np.array([[j for j in range(4) if j != a]
                               for a in apex])
            pa = p[sel, apex]
            va = v[sel, apex]
            tri = []
            for k in range(3):
                pb = p[sel, others[:, k]]
                vb = v[sel, others[:, k]]
                tri.append(edge_point(pa, pb, va, vb))
            tris.append(np.stack(tri, axis=1))

        # case: two corners inside -> quad -> 2 triangles
        sel = np.where(n_in == 2)[0]
        if len(sel) > 0:
            ins = inside[sel]
            in_idx = np.argsort(~ins, axis=-1)[:, :2]      # two inside
            out_idx = np.argsort(ins, axis=-1)[:, :2]      # two outside
            pa0 = p[sel, in_idx[:, 0]]
            va0 = v[sel, in_idx[:, 0]]
            pa1 = p[sel, in_idx[:, 1]]
            va1 = v[sel, in_idx[:, 1]]
            pb0 = p[sel, out_idx[:, 0]]
            vb0 = v[sel, out_idx[:, 0]]
            pb1 = p[sel, out_idx[:, 1]]
            vb1 = v[sel, out_idx[:, 1]]
            e00 = edge_point(pa0, pb0, va0, vb0)
            e01 = edge_point(pa0, pb1, va0, vb1)
            e10 = edge_point(pa1, pb0, va1, vb0)
            e11 = edge_point(pa1, pb1, va1, vb1)
            tris.append(np.stack([e00, e01, e11], axis=1))
            tris.append(np.stack([e00, e11, e10], axis=1))

    tri = np.concatenate(tris, axis=0)      # (T, 3, 3)
    # weld vertices
    flat = tri.reshape(-1, 3)
    key = np.round(flat / max(spacing, 1e-9) * 1e5).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3))
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq))[:, None]
    verts = verts / counts
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & \
         (faces[:, 0] != faces[:, 2])
    faces = faces[ok]
    verts = verts * spacing
    if origin is not None:
        verts = verts + np.asarray(origin)
    return verts, faces


def extract_mesh(rc, params, pose, radius: float = 1.0, res: int = 64,
                 threshold: float = 10., state=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Density grid -> isosurface mesh in world coordinates
    (reference render_mesh, run_render.py:970-986)."""
    sigma = extract_density_grid(rc, params, pose, radius, res, state=state)
    center = pose['kps'][0, 0].detach().cpu().numpy()
    spacing = 2 * radius / res
    origin = center - radius
    # note: grid was built with meshgrid default (xy) indexing like the
    # reference; swap axes so verts land in world xyz
    sigma_xyz = np.transpose(sigma, (1, 0, 2))
    verts, faces = marching_tetrahedra(sigma_xyz, threshold,
                                       origin=origin, spacing=spacing)
    return verts, faces


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal ASCII PLY writer (replaces trimesh.export)."""
    with open(path, 'w') as f:
        f.write('ply\nformat ascii 1.0\n')
        f.write(f'element vertex {len(verts)}\n')
        f.write('property float x\nproperty float y\nproperty float z\n')
        f.write(f'element face {len(faces)}\n')
        f.write('property list uchar int vertex_indices\nend_header\n')
        for v in verts:
            f.write(f'{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n')
        for face in faces:
            f.write(f'3 {face[0]} {face[1]} {face[2]}\n')


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    verts, faces = [], []
    with open(path) as f:
        n_v = n_f = 0
        for line in f:
            line = line.strip()
            if line.startswith('element vertex'):
                n_v = int(line.split()[-1])
            elif line.startswith('element face'):
                n_f = int(line.split()[-1])
            elif line == 'end_header':
                break
        for _ in range(n_v):
            verts.append([float(x) for x in next(f).split()[:3]])
        for _ in range(n_f):
            parts = next(f).split()
            faces.append([int(x) for x in parts[1:4]])
    return (np.array(verts).reshape(-1, 3),
            np.array(faces, np.int64).reshape(-1, 3))


def compute_vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def rasterize_mesh(verts: np.ndarray, faces: np.ndarray,
                   H: int = 512, W: int = 512,
                   c2w: Optional[np.ndarray] = None,
                   focal: Optional[float] = None,
                   center: Optional[np.ndarray] = None,
                   return_mask: bool = False):
    """Normal-colored z-buffer rasterization (the software replacement
    for the reference's EGL ColorRender, render/color_render.py:31-113).

    Returns an (H, W, 3) float image in [0, 1]; with ``return_mask``
    also the (H, W) coverage mask.
    """
    if len(verts) == 0:
        blank = np.ones((H, W, 3), np.float32)
        return (blank, np.zeros((H, W), bool)) if return_mask else blank
    mesh_center = verts.mean(0)
    scale = np.abs(verts - mesh_center).max()
    if c2w is None:
        c2w = np.eye(4)
        c2w[:3, 3] = mesh_center + np.array([0., 0., 3.5 * scale])
    if focal is None:
        focal = 1.2 * W

    w2c = np.linalg.inv(c2w)
    vh = np.concatenate([verts, np.ones((len(verts), 1))], -1)
    cam = (vh @ w2c.T)[:, :3]
    z = -cam[:, 2]
    valid_z = np.maximum(z, 1e-6)
    cx = W * 0.5 if center is None else float(center[0])
    cy = H * 0.5 if center is None else float(center[1])
    px = cam[:, 0] / valid_z * focal + cx
    py = -cam[:, 1] / valid_z * focal + cy

    normals = compute_vertex_normals(verts, faces)
    colors = normals * 0.5 + 0.5

    img = np.ones((H, W, 3), np.float32)
    zbuf = np.full((H, W), np.inf)
    p2 = np.stack([px, py], -1)
    for f in faces:
        tri = p2[f]
        tz = z[f]
        tc = colors[f]
        xmin = max(int(np.floor(tri[:, 0].min())), 0)
        xmax = min(int(np.ceil(tri[:, 0].max())), W - 1)
        ymin = max(int(np.floor(tri[:, 1].min())), 0)
        ymax = min(int(np.ceil(tri[:, 1].max())), H - 1)
        if xmin > xmax or ymin > ymax:
            continue
        xs, ys = np.meshgrid(np.arange(xmin, xmax + 1),
                             np.arange(ymin, ymax + 1))
        d = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float64)
        v0, v1, v2 = tri[0], tri[1], tri[2]
        den = (v1[1] - v2[1]) * (v0[0] - v2[0]) + \
              (v2[0] - v1[0]) * (v0[1] - v2[1])
        if abs(den) < 1e-12:
            continue
        a = ((v1[1] - v2[1]) * (d[:, 0] - v2[0]) +
             (v2[0] - v1[0]) * (d[:, 1] - v2[1])) / den
        b = ((v2[1] - v0[1]) * (d[:, 0] - v2[0]) +
             (v0[0] - v2[0]) * (d[:, 1] - v2[1])) / den
        c = 1. - a - b
        inside = (a >= 0) & (b >= 0) & (c >= 0)
        if not inside.any():
            continue
        d_in = d[inside].astype(np.int64)
        zi = a[inside] * tz[0] + b[inside] * tz[1] + c[inside] * tz[2]
        ci = (a[inside, None] * tc[0] + b[inside, None] * tc[1] +
              c[inside, None] * tc[2])
        for (x, y), zz, cc in zip(d_in, zi, ci):
            if zz < zbuf[y, x]:
                zbuf[y, x] = zz
                img[y, x] = cc
    if return_mask:
        return img, np.isfinite(zbuf)
    return img


def overlay_mesh(image: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                 c2w: np.ndarray, focal: float,
                 center: Optional[np.ndarray] = None,
                 alpha: float = 0.8) -> np.ndarray:
    """Composite a (e.g. SMPL) mesh render over an image — the software
    replacement for the reference's pyrender overlay visualizer
    (core/misc/renderer.py: Renderer.__call__(vertices, image, focal,
    center, camera_pose))."""
    H, W = image.shape[:2]
    shaded, mask = rasterize_mesh(verts, faces, H, W, c2w=c2w,
                                  focal=focal, center=center,
                                  return_mask=True)
    out = np.asarray(image, np.float32).copy()
    m = mask[..., None].astype(np.float32) * alpha
    out = out * (1. - m) + shaded * m
    return out


def render_turntable(verts: np.ndarray, faces: np.ndarray,
                     n_views: int = 20, H: int = 512,
                     W: int = 512) -> np.ndarray:
    """Turntable render of an extracted mesh (replaces render_mesh.py)."""
    from .poses import generate_bullet_time
    center = verts.mean(0) if len(verts) else np.zeros(3)
    scale = np.abs(verts - center).max() if len(verts) else 1.
    base = np.eye(4)
    base[:3, 3] = np.array([0., 0., 3.5 * scale])
    c2ws = generate_bullet_time(base, n_views=n_views)
    frames = []
    vc = verts - center
    for c2w in c2ws:
        frames.append(rasterize_mesh(vc, faces, H, W, c2w=c2w))
    return np.stack(frames)
