"""KITTI velodyne -> depth-map projection (the port's copy of
mono_vifi_tpu/data/kitti_utils.py; reference kitti_utils.py:17-98)."""

from __future__ import annotations

import os
from collections import Counter

import numpy as np


def read_calib_file(path: str) -> dict:
    """Parse a KITTI calibration txt into a dict of float arrays."""
    data = {}
    with open(path, "r") as f:
        for line in f.readlines():
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            data[key] = value
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    """Load (N, 4) velodyne scan; homogeneous coordinate set to 1."""
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    points[:, 3] = 1.0
    return points


def sub2ind(matrix_size, row_sub, col_sub):
    m, n = matrix_size
    return row_sub * (n - 1) + col_sub - 1


def generate_depth_map(calib_dir: str, velo_filename: str, cam: int = 2,
                       vel_depth: bool = False) -> np.ndarray:
    """Project a velodyne scan into camera `cam`'s image plane; duplicate
    pixels keep the minimum depth (occlusion handling)."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    T_velo2cam = np.hstack(
        (velo2cam["R"].reshape(3, 3), velo2cam["T"][..., np.newaxis])
    )
    T_velo2cam = np.vstack((T_velo2cam, np.array([0, 0, 0, 1.0])))

    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)

    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    P_velo2im = np.dot(np.dot(P_rect, R_rect), T_velo2cam)

    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0, :]  # points behind the image plane

    pts_im = np.dot(P_velo2im, velo.T).T
    pts_im[:, :2] = pts_im[:, :2] / pts_im[:, 2][..., np.newaxis]
    if vel_depth:
        pts_im[:, 2] = velo[:, 0]

    # round to nearest pixel (-1 for 1-based KITTI indexing convention)
    pts_im[:, 0] = np.round(pts_im[:, 0]) - 1
    pts_im[:, 1] = np.round(pts_im[:, 1]) - 1
    val = (
        (pts_im[:, 0] >= 0)
        & (pts_im[:, 1] >= 0)
        & (pts_im[:, 0] < im_shape[1])
        & (pts_im[:, 1] < im_shape[0])
    )
    pts_im = pts_im[val, :]

    depth = np.zeros(im_shape)
    depth[pts_im[:, 1].astype(np.int32), pts_im[:, 0].astype(np.int32)] = pts_im[:, 2]

    # duplicate pixels: keep minimum depth
    inds = sub2ind(depth.shape, pts_im[:, 1], pts_im[:, 0])
    dupe_inds = [item for item, count in Counter(inds).items() if count > 1]
    for dd in dupe_inds:
        pts = np.where(inds == dd)[0]
        x_loc = int(pts_im[pts[0], 0])
        y_loc = int(pts_im[pts[0], 1])
        depth[y_loc, x_loc] = pts_im[pts, 2].min()
    depth[depth < 0] = 0
    return depth
