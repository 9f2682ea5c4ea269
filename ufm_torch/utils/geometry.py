"""Camera-geometry / evaluation utilities (counterpart of
``ufm_tpu/utils/geometry.py``).

Depth to point cloud, projection, intrinsics conventions, point-cloud
statistics, reciprocal matching and quaternions, in numpy on the host
(evaluation tooling: depth-based ground-truth flow for matching benchmarks).
Only :func:`get_meshgrid_torch` builds a tensor, on the device it is given.
Reciprocal matching uses scipy's ``cKDTree``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "depthmap_to_camera_frame",
    "depthmap_to_world_frame",
    "xy_grid",
    "geotrf",
    "inv",
    "get_meshgrid",
    "get_meshgrid_torch",
    "depthmap_to_camera_coordinates",
    "depthmap_to_pts3d",
    "z_depthmap_to_norm_depthmap",
    "z_depthmap_to_norm_depthmap_batched",
    "depthmap_to_absolute_camera_coordinates",
    "global_points_to_local",
    "project_points_to_pixels",
    "project_points_to_pixels_batched",
    "colmap_to_opencv_intrinsics",
    "opencv_to_colmap_intrinsics",
    "get_joint_pointcloud_depth",
    "get_joint_pointcloud_center_scale",
    "find_reciprocal_matches",
    "rotate_vector_with_quaternion",
    "quaternion_to_rot_matrix",
    "flow_from_depth_pair",
]


@lru_cache(maxsize=16)
def get_meshgrid(W: int, H: int):
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return u, v


def get_meshgrid_torch(W: int, H: int, device=None):
    """(H, W, 2) xy float32 grid as a tensor on ``device`` (default: the
    CPU)."""
    import torch

    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack((u, v), dim=-1)


def xy_grid(W, H, device=None, origin=(0, 0), unsqueeze=None, cat_dim=-1, homogeneous=False, **arange_kw):
    """(H, W, 2) int grid with output[j, i] = (i + ox, j + oy)."""
    tw = np.arange(origin[0], origin[0] + W, **arange_kw)
    th = np.arange(origin[1], origin[1] + H, **arange_kw)
    grid = list(np.meshgrid(tw, th, indexing="xy"))
    if homogeneous:
        grid.append(np.ones((H, W)))
    if unsqueeze is not None:
        grid = [np.expand_dims(g, unsqueeze) for g in grid]
    if cat_dim is not None:
        return np.stack(grid, axis=cat_dim)
    return tuple(grid)


def depthmap_to_camera_frame(depthmap, intrinsics):
    """(H, W) depth + 3x3 K -> ((H, W, 3) points, valid mask)."""
    depthmap = np.asarray(depthmap)
    intrinsics = np.asarray(intrinsics)
    h, w = depthmap.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x, y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xx = (x - cx) * depthmap / fx
    yy = (y - cy) * depthmap / fy
    pts = np.stack((xx, yy, depthmap), axis=-1)
    return pts, depthmap > 0.0


def depthmap_to_world_frame(depthmap, intrinsics, camera_pose=None):
    pts_cam, valid = depthmap_to_camera_frame(depthmap, intrinsics)
    if camera_pose is None:
        return pts_cam, valid
    r, t = np.asarray(camera_pose)[:3, :3], np.asarray(camera_pose)[:3, 3]
    return pts_cam @ r.T + t, valid


def geotrf(Trf, pts, ncol=None, norm=False):
    """Apply a 3x3/4x4 (optionally batched) transform to (..., 2|3) points."""
    Trf = np.asarray(Trf)
    pts = np.asarray(pts, dtype=float)
    output_reshape = pts.shape[:-1]
    ncol = ncol or pts.shape[-1]
    d = pts.shape[-1]

    if Trf.ndim >= 3:
        n = Trf.ndim - 2
        assert Trf.shape[:n] == pts.shape[:n], "batch size does not match"
        Trf = Trf.reshape(-1, Trf.shape[-2], Trf.shape[-1])
        if pts.ndim > Trf.ndim:
            pts = pts.reshape(Trf.shape[0], -1, pts.shape[-1])
        elif pts.ndim == 2:
            pts = pts[:, None, :]

    if d + 1 == Trf.shape[-1]:
        TrfT = np.swapaxes(Trf, -1, -2)
        pts = pts @ TrfT[..., :-1, :] + TrfT[..., -1:, :]
    elif d == Trf.shape[-1]:
        pts = pts @ np.swapaxes(Trf, -1, -2)
    else:
        raise ValueError(f"bad shape {pts.shape} for transform {Trf.shape}")

    if norm:
        pts = pts / pts[..., -1:]
        if norm != 1:
            pts = pts * norm
    return pts[..., :ncol].reshape(*output_reshape, ncol)


def inv(mat):
    return np.linalg.inv(np.asarray(mat))


def depthmap_to_pts3d(depth, pseudo_focal, pp=None, **_):
    """Batched depth → pointmap with per-pixel pseudo-focal (reference
    geometry.py:166-214). depth: (B, H, W); pseudo_focal: (B, H, W) or
    (B, 1|2, H, W); returns (B, H, W, 3)."""
    depth = np.asarray(depth)
    pseudo_focal = np.asarray(pseudo_focal)
    b, h, w = depth.shape[:3]

    if pseudo_focal.ndim == 3:
        fx = fy = pseudo_focal
    elif pseudo_focal.ndim == 4:
        fx = pseudo_focal[:, 0]
        fy = pseudo_focal[:, 1] if pseudo_focal.shape[1] == 2 else fx
    else:
        raise NotImplementedError("unknown pseudo_focal shape")

    gx, gy = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    if pp is None:
        gx = gx - (w - 1) / 2
        gy = gy - (h - 1) / 2
        gx = np.broadcast_to(gx, (b, h, w))
        gy = np.broadcast_to(gy, (b, h, w))
    else:
        pp = np.asarray(pp)
        gx = gx[None] - pp[:, 0, None, None]
        gy = gy[None] - pp[:, 1, None, None]

    pts = np.empty((b, h, w, 3), dtype=np.float64)
    pts[..., 0] = depth * gx / fx
    pts[..., 1] = depth * gy / fy
    pts[..., 2] = depth
    return pts


def depthmap_to_camera_coordinates(depthmap, camera_intrinsics, pseudo_focal=None):
    camera_intrinsics = np.float32(camera_intrinsics)
    h, w = depthmap.shape
    assert camera_intrinsics[0, 1] == 0.0 and camera_intrinsics[1, 0] == 0.0
    if pseudo_focal is None:
        fu, fv = camera_intrinsics[0, 0], camera_intrinsics[1, 1]
    else:
        assert pseudo_focal.shape == (h, w)
        fu = fv = pseudo_focal
    cu, cv = camera_intrinsics[0, 2], camera_intrinsics[1, 2]
    u, v = get_meshgrid(w, h)
    x_cam = np.zeros((h, w, 3), dtype=np.float32)
    x_cam[..., 0] = (u - cu) * depthmap / fu
    x_cam[..., 1] = (v - cv) * depthmap / fv
    x_cam[..., 2] = depthmap
    return x_cam, depthmap > 0.0


def z_depthmap_to_norm_depthmap(z_depthmap, camera_intrinsics, pseudo_focal=None):
    camera_intrinsics = np.float32(camera_intrinsics)
    h, w = z_depthmap.shape
    assert camera_intrinsics[0, 1] == 0.0 and camera_intrinsics[1, 0] == 0.0
    if pseudo_focal is None:
        fu, fv = camera_intrinsics[0, 0], camera_intrinsics[1, 1]
    else:
        fu = fv = pseudo_focal
    cu, cv = camera_intrinsics[0, 2], camera_intrinsics[1, 2]
    rays = np.ones((h, w, 3), dtype=np.float32)
    u, v = get_meshgrid(w, h)
    rays[..., 0] = (u - cu) / fu
    rays[..., 1] = (v - cv) / fv
    return z_depthmap * np.linalg.norm(rays, axis=-1)


def z_depthmap_to_norm_depthmap_batched(z_depthmap, camera_intrinsics, pseudo_focal=None):
    z = np.asarray(z_depthmap)
    K = np.asarray(camera_intrinsics)
    b, h, w = z.shape
    assert (K[..., 0, 1] == 0.0).all() and (K[..., 1, 0] == 0.0).all()
    fu = K[..., 0, 0].reshape(b, 1, 1)
    fv = K[..., 1, 1].reshape(b, 1, 1)
    cu = K[..., 0, 2].reshape(b, 1, 1)
    cv = K[..., 1, 2].reshape(b, 1, 1)
    u, v = get_meshgrid(w, h)
    rays = np.ones((b, h, w, 3), dtype=z.dtype)
    rays[..., 0] = (u[None] - cu) / fu
    rays[..., 1] = (v[None] - cv) / fv
    return z * np.linalg.norm(rays, axis=-1)


def depthmap_to_absolute_camera_coordinates(depthmap, camera_intrinsics, camera_pose, **kw):
    x_cam, valid = depthmap_to_camera_coordinates(depthmap, camera_intrinsics)
    if camera_pose is None:
        return x_cam, valid
    pose = np.asarray(camera_pose)
    return x_cam @ pose[:3, :3].T + pose[:3, 3][None, None, :], valid


def global_points_to_local(pts, camera_pose):
    world_to_cam = np.linalg.inv(np.asarray(camera_pose))
    r, t = world_to_cam[:3, :3], world_to_cam[:3, 3]
    return np.einsum("ik,vuk->vui", r, np.asarray(pts)) + t[None, None, :]


def project_points_to_pixels(pts_camera, camera_intrinsics, pseudo_focal=None):
    K = np.float32(camera_intrinsics)
    h, w = pts_camera.shape[:2]
    assert K[0, 1] == 0.0 and K[1, 0] == 0.0
    if pseudo_focal is None:
        fu, fv = K[0, 0], K[1, 1]
    else:
        fu = fv = pseudo_focal
    cu, cv = K[0, 2], K[1, 2]
    x, y, z = pts_camera[..., 0], pts_camera[..., 1], pts_camera[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.stack([fu * x / z + cu, fv * y / z + cv], axis=-1).astype(np.float32)
    valid = (z > 0.0) & (uv[..., 0] >= -0.5) & (uv[..., 0] < w - 0.5) & (uv[..., 1] >= -0.5) & (uv[..., 1] < h - 0.5)
    return uv, valid


def project_points_to_pixels_batched(pts_camera, camera_intrinsics, pseudo_focal=None):
    pts = np.asarray(pts_camera)
    K = np.asarray(camera_intrinsics)
    b, h, w, _ = pts.shape
    assert (K[..., 0, 1] == 0.0).all() and (K[..., 1, 0] == 0.0).all()
    fu = K[..., 0, 0].reshape(b, 1, 1)
    fv = K[..., 1, 1].reshape(b, 1, 1)
    cu = K[..., 0, 2].reshape(b, 1, 1)
    cv = K[..., 1, 2].reshape(b, 1, 1)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.stack([fu * x / z + cu, fv * y / z + cv], axis=-1)
    valid = (z > 0.0) & (uv[..., 0] >= -0.5) & (uv[..., 0] < w - 0.5) & (uv[..., 1] >= -0.5) & (uv[..., 1] < h - 0.5)
    return uv, valid


def colmap_to_opencv_intrinsics(K):
    K = np.asarray(K).copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K):
    K = np.asarray(K).copy()
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def _invalid_to_nans(arr, valid_mask):
    arr = np.asarray(arr, dtype=float).copy()
    if valid_mask is not None:
        arr[~np.asarray(valid_mask, dtype=bool)] = np.nan
    return arr


def get_joint_pointcloud_depth(z1, z2, valid_mask1, valid_mask2=None, quantile=0.5):
    _z1 = _invalid_to_nans(z1, valid_mask1).reshape(len(z1), -1)
    _z2 = _invalid_to_nans(z2, valid_mask2).reshape(len(z2), -1) if z2 is not None else None
    _z = np.concatenate((_z1, _z2), axis=-1) if _z2 is not None else _z1
    if quantile == 0.5:
        return np.nanmedian(_z, axis=-1)
    return np.nanquantile(_z, quantile, axis=-1)


def get_joint_pointcloud_center_scale(pts1, pts2, valid_mask1=None, valid_mask2=None, z_only=False, center=True):
    _pts1 = _invalid_to_nans(pts1, valid_mask1).reshape(len(pts1), -1, 3)
    _pts2 = _invalid_to_nans(pts2, valid_mask2).reshape(len(pts2), -1, 3) if pts2 is not None else None
    _pts = np.concatenate((_pts1, _pts2), axis=1) if _pts2 is not None else _pts1

    _center = np.nanmedian(_pts, axis=1, keepdims=True)
    if z_only:
        _center[..., :2] = 0
    _norm = np.linalg.norm((_pts - _center) if center else _pts, axis=-1)
    scale = np.nanmedian(_norm, axis=1)
    return _center[:, None, :, :], scale[:, None, None, None]


def find_reciprocal_matches(P1, P2):
    """Mutual nearest neighbors between two point sets.

    Returns ``(mask2, idx2_to_1, n)``: a boolean mask over ``P2`` marking the
    points whose nearest neighbor in ``P1`` points back at them, the P2->P1
    nearest-neighbor index array, and the mutual-match count — the same
    contract as the reference's helper (reference utils/geometry.py:525-542,
    itself the canonical mutual-NN idiom credited there to DUSt3R), with the
    reference's missing ``KDTree`` import fixed by using scipy's ``cKDTree``.
    """
    from scipy.spatial import cKDTree

    idx1_to_2 = cKDTree(P2).query(P1, workers=-1)[1]  # each P1 point's NN in P2
    idx2_to_1 = cKDTree(P1).query(P2, workers=-1)[1]  # each P2 point's NN in P1
    # a pair is mutual when following both hops returns to the start
    mask1 = idx2_to_1[idx1_to_2] == np.arange(len(P1))
    mask2 = idx1_to_2[idx2_to_1] == np.arange(len(P2))
    assert mask1.sum() == mask2.sum()
    return mask2, idx2_to_1, int(mask2.sum())


def rotate_vector_with_quaternion(v, quat, scalar_first: bool = False, skip_norm: bool = False):
    v = np.asarray(v, dtype=float)
    quat = np.asarray(quat, dtype=float)
    if scalar_first:
        w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    else:
        x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    if not skip_norm:
        n = np.sqrt(w**2 + x**2 + y**2 + z**2 + 1e-8)
        w, x, y, z = w / n, x / n, y / n, z / n
    q_vec = np.stack([x, y, z], axis=-1)
    t = 2 * np.cross(q_vec, v)
    return v + w[..., None] * t + np.cross(q_vec, t)


def quaternion_to_rot_matrix(quat, scalar_first: bool = False):
    quat = np.asarray(quat, dtype=float)
    if scalar_first:
        w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    else:
        x, y, z, w = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    n = np.sqrt(w**2 + x**2 + y**2 + z**2 + 1e-8)
    w, x, y, z = w / n, x / n, y / n, z / n
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot = np.empty(quat.shape[:-1] + (3, 3))
    rot[..., 0, 0] = 1 - 2 * (yy + zz)
    rot[..., 0, 1] = 2 * (xy - wz)
    rot[..., 0, 2] = 2 * (xz + wy)
    rot[..., 1, 0] = 2 * (xy + wz)
    rot[..., 1, 1] = 1 - 2 * (xx + zz)
    rot[..., 1, 2] = 2 * (yz - wx)
    rot[..., 2, 0] = 2 * (xz - wy)
    rot[..., 2, 1] = 2 * (yz + wx)
    rot[..., 2, 2] = 1 - 2 * (xx + yy)
    return rot


def flow_from_depth_pair(depth0, K0, pose0, K1, pose1):
    """Ground-truth flow + covisibility proxy from depth/pose pairs (the
    matching-benchmark evaluation path the reference's geometry utilities
    support). Returns ((H, W, 2) flow, (H, W) valid)."""
    pts_world, valid = depthmap_to_world_frame(depth0, K0, pose0)
    pts_cam1 = global_points_to_local(pts_world, pose1)
    uv1, in_view = project_points_to_pixels(pts_cam1.astype(np.float32), K1)
    h, w = depth0.shape
    u0, v0 = get_meshgrid(w, h)
    flow = uv1 - np.stack([u0, v0], axis=-1)
    return flow, valid & in_view
