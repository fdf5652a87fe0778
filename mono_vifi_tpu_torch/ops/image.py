"""Image resampling ops (counterpart of mono_vifi_tpu/ops/image.py).

Images here are channel-planar (B, C, H, W), the layout of the JAX
package's photometric planes and of PyTorch's convolutions; tests transpose
the JAX package's NHWC arrays. Bilinear resize keeps the JAX package's
interpolation-matrix semantics (torch `F.interpolate`, bilinear, either
`align_corners`), and the per-sample crop and place resizes are
per-sample interpolation matrices applied with batched matmuls.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mono_vifi_tpu_torch.ops.cuda.splat import grid_sample_frozen_grid
from mono_vifi_tpu_torch.ops.sampling import sample_planar

# Small constant tensors of the models, made once per key, dtype and device.
# Built from host values, each is a blocking host-to-device copy that waits
# for the device's queue to drain, and no such copy may run while a CUDA
# graph captures; from this cache a call at shapes seen before copies none.
_CONSTANTS: dict = {}
# constants made (cache misses): a call at shapes seen before adds none
CONSTANT_COUNTS = {"misses": 0}


def reset_constant_counts() -> None:
    CONSTANT_COUNTS["misses"] = 0


def device_constant(values, dtype, device, make=None) -> torch.Tensor:
    """The tensor `torch.tensor(values, dtype=dtype)` on `device`, made once.
    With `make`, `values` is only the key and `make()` builds the CPU tensor.
    Callers must not write to the result: every caller shares it."""
    key = (values, dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = make() if make else torch.tensor(values, dtype=dtype)
        t = t.to(device=device, dtype=dtype)
        _CONSTANTS[key] = t
        CONSTANT_COUNTS["misses"] += 1
    return t


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) bilinear interpolation matrix, torch rules."""
    if align_corners:
        if out_size == 1:
            src = np.zeros((1,), np.float64)
        else:
            src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
        src = np.maximum(src, 0.0)
    i0 = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    lam = src - i0
    i1 = np.minimum(i0 + 1, in_size - 1)
    M = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(M, (rows, i0), (1.0 - lam).astype(np.float32))
    np.add.at(M, (rows, i1), lam.astype(np.float32))
    return M


def resize_bilinear(x, size, align_corners: bool = False):
    """Bilinear resize of (B, C, H, W) `x` to `size` = (Ho, Wo) as two
    interpolation-matrix products in the dtype of x."""
    H, W = x.shape[-2:]
    Ho, Wo = size
    if (Ho, Wo) == (H, W):
        return x
    Mh, Mw = (
        device_constant(("interp", n, m, align_corners), x.dtype, x.device,
                        lambda: torch.from_numpy(_interp_matrix(n, m, align_corners)))
        for n, m in ((H, Ho), (W, Wo)))
    return torch.matmul(torch.matmul(Mh, x), Mw.t())


def upsample_nearest(x, factor: int = 2):
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def reflect_pad_2d(x, pad: int = 1):
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


def rotation_grid(angle_deg, height: int, width: int):
    """Normalized (gx, gy) planes (B, H, W) of a rotation by `angle_deg`
    (B,) counterclockwise about the centre of the pixel centres (torchvision
    `rotate` on tensors), align_corners=True."""
    theta = angle_deg.float() * (math.pi / 180.0)
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    dev = angle_deg.device
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - cx).view(1, 1, width)
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - cy).view(1, height, 1)
    sx = cos * xs - sin * ys + cx
    sy = sin * xs + cos * ys + cy
    return (sx / (width - 1) - 0.5) * 2.0, (sy / (height - 1) - 0.5) * 2.0


def rotate_bilinear(img, angle_deg, grad_via_splat: bool = False):
    """Batched rotation (one angle per sample), bilinear, zero fill.

    Without `grad_via_splat` the image is treated as gradient-free (it is
    detached: the synthesized frames of the affine branch) and goes through
    the `bilinear_sample` kernel. With it, the image's gradient comes from the
    `bilinear_splat` kernel (the SADC depth restore); the angles are frozen
    in both cases."""
    B, C, H, W = img.shape
    gx, gy = rotation_grid(angle_deg, H, W)
    if grad_via_splat:
        return grid_sample_frozen_grid(img, gx, gy, "zeros")
    return sample_planar(img.detach(), gx, gy, "zeros")


def _interp_rows(src, inside, in_size: int):
    """Per-sample interpolation matrices (B, out, in) from float source
    coordinates `src` (B, out) already clamped to [0, in_size - 1]; `inside`
    (B, out) zeroes whole output rows."""
    i0 = torch.floor(src).clamp(0, in_size - 2)
    f = (src - i0)[..., None]
    i = torch.arange(in_size, dtype=src.dtype, device=src.device)
    i0 = i0[..., None]
    M = (i == i0).to(src.dtype) * (1.0 - f) + (i == i0 + 1).to(src.dtype) * f
    return M * inside[..., None]


def _apply_rows_cols(img, My, Mx):
    My = My.to(img.dtype)[:, None]
    Mx = Mx.to(img.dtype)[:, None]
    return torch.matmul(torch.matmul(My, img), Mx.transpose(-1, -2))


def batched_crop_resize(img, box):
    """Crop per-sample `box` = (x0, y0, w, h) and resize back to (H, W):
    `F.interpolate(img[..., y0:y0+h, x0:x0+w], (H, W))` per sample, with
    coordinates border-clamped to the image (reference train.py:899-900)."""
    B, C, H, W = img.shape
    box = box.float()
    x0, y0, w, h = box[:, 0:1], box[:, 1:2], box[:, 2:3], box[:, 3:4]
    j = torch.arange(W, dtype=torch.float32, device=img.device)[None]
    i = torch.arange(H, dtype=torch.float32, device=img.device)[None]
    sx = torch.minimum(torch.clamp((j + 0.5) * (w / W) - 0.5, min=0.0), w - 1)
    sy = torch.minimum(torch.clamp((i + 0.5) * (h / H) - 0.5, min=0.0), h - 1)
    sx = (sx + x0).clamp(0.0, W - 1.0)
    sy = (sy + y0).clamp(0.0, H - 1.0)
    My = _interp_rows(sy, torch.ones_like(sy), H)
    Mx = _interp_rows(sx, torch.ones_like(sx), W)
    return _apply_rows_cols(img, My, Mx)


def batched_place_resize(img, box):
    """Resize each sample to (h, w) and place it at (x0, y0) in a zero
    canvas (reference train.py:912-914)."""
    B, C, H, W = img.shape
    box = box.float()
    x0, y0, w, h = box[:, 0:1], box[:, 1:2], box[:, 2:3], box[:, 3:4]
    j = torch.arange(W, dtype=torch.float32, device=img.device)[None]
    i = torch.arange(H, dtype=torch.float32, device=img.device)[None]
    jj = j - x0
    ii = i - y0
    inside_x = ((jj >= 0) & (jj < w)).float()
    inside_y = ((ii >= 0) & (ii < h)).float()
    sx = ((jj + 0.5) * (W / w) - 0.5).clamp(0.0, W - 1)
    sy = ((ii + 0.5) * (H / h) - 0.5).clamp(0.0, H - 1)
    My = _interp_rows(sy, inside_y, H)
    Mx = _interp_rows(sx, inside_x, W)
    return _apply_rows_cols(img, My, Mx)
