"""Camera geometry: disparity/depth conversion, SE(3) from axis-angle, the
fused backproject-project reprojection grid and the affine-branch pose
conjugation (counterpart of mono_vifi_tpu/ops/geometry.py).

The JAX package pins these products to full f32 precision. Here every small
matrix product is written as broadcast multiplies and sums, so it runs in
true f32 on any device and never reaches TF32 tensor cores.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k) @ (..., k, m) as an elementwise f32 reduction."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def disp_to_depth(disp: torch.Tensor, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth), reference layers.py:16-25."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 3) -> (B, 4, 4) rotation (Rodrigues, 1e-7 epsilon)."""
    angle = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., 0]
    sa = torch.sin(angle)[..., 0]
    C = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    rot = torch.stack(
        [
            x * xC + ca, xyC - zs, zxC + ys, zeros,
            xyC + zs, y * yC + ca, yzC - xs, zeros,
            zxC - ys, yzC + xs, z * zC + ca, zeros,
            zeros, zeros, zeros, ones,
        ],
        dim=-1,
    )
    return rot.reshape(vec.shape[0], 4, 4)


def get_translation_matrix(translation: torch.Tensor) -> torch.Tensor:
    B = translation.shape[0]
    T = torch.eye(4, dtype=translation.dtype, device=translation.device)
    T = T.expand(B, 4, 4).clone()
    T[:, :3, 3] = translation
    return T


def transformation_from_parameters(
    axisangle: torch.Tensor, translation: torch.Tensor, invert: bool = False
) -> torch.Tensor:
    """(axis-angle, translation) -> (B, 4, 4): T @ R, or R^T @ T(-t) inverted.

    Computed in f32 and returned in the input dtype."""
    dtype = axisangle.dtype
    R = rot_from_axisangle(axisangle.float())
    t = translation.float()
    if invert:
        out = _mm(R.transpose(1, 2), get_translation_matrix(-t))
    else:
        out = _mm(get_translation_matrix(t), R)
    return out.to(dtype)


def reprojection_grid_planar(depth, K, inv_K, T, eps: float = 1e-7):
    """Target depth (B, H, W) -> source sampling coordinates (gx, gy), each
    (B, H, W), normalized for align_corners=True (reference BackprojectDepth
    + Project3D, collapsed to one 3x3 product per batch entry)."""
    B, H, W = depth.shape
    P = _mm(K.float(), T.float())
    A = _mm(P[:, :3, :3], inv_K[:, :3, :3].float())  # (B, 3, 3)
    b = P[:, :3, 3]
    xs = torch.arange(W, dtype=torch.float32, device=depth.device).view(1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=depth.device).view(1, H, 1)
    cam = []
    for i in range(3):
        ray = (
            A[:, i, 0, None, None] * xs
            + A[:, i, 1, None, None] * ys
            + A[:, i, 2, None, None]
        )
        cam.append(depth * ray + b[:, i, None, None])
    x = cam[0] / (cam[2] + eps)
    y = cam[1] / (cam[2] + eps)
    gx = (x / (W - 1) - 0.5) * 2.0
    gy = (y / (H - 1) - 0.5) * 2.0
    return gx, gy


def conjugate_pose(pose: torch.Tensor, Rc: torch.Tensor) -> torch.Tensor:
    """Affine-branch conjugation (reference train.py:819-828): rotation block
    Rc @ R @ Rc^-1, translation Rc @ t, bottom row zero. f32 inside, returned
    in the pose dtype. The inverse skips `linalg.inv`'s check for singular
    input, which reads the device's status on the host: Rc is a rotation."""
    R = pose[:, :3, :3].float()
    t = pose[:, :3, 3:4].float()
    Rc = Rc.float()
    out = torch.zeros(pose.shape, dtype=torch.float32, device=pose.device)
    out[:, :3, :3] = _mm(Rc, _mm(R, torch.linalg.inv_ex(Rc).inverse))
    out[:, :3, 3:4] = _mm(Rc, t)
    return out.to(pose.dtype)
