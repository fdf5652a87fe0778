"""Analytic multi-view-consistent synthetic scene (the port's copy of
tests/synthetic_scene.py, numpy and PIL only), for the convergence smoke
(mono_vifi_tpu_torch.convergence_smoke).

A slanted textured plane Z = a + b*X viewed by a translating pinhole camera.
The texture is a sum of sinusoids evaluated analytically at each view's
plane intersection, so the three rendered frames are EXACTLY photometrically
consistent under the true depth + poses (no resampling error) — the
photometric loss of the true solution is ~0, and training the full Mono-ViFI
step on this scene must drive depth toward the (median-scaled) truth.

Protects reference behavior train.py:698-941 (does training actually
minimize the objective) and the hand-written kernels' numerics (bf16 taps)
against silent corruption that "loss is finite" tests cannot see.
"""

from __future__ import annotations

import numpy as np

_FREQS = [(1.3, 0.9), (2.7, 1.9), (5.1, 4.3), (9.7, 8.9)]
_AMPS = [0.22, 0.14, 0.08, 0.05]


def _texture(X, Y, channel_phase):
    v = 0.5 * np.ones_like(X)
    for (fx, fy), amp in zip(_FREQS, _AMPS):
        v = v + amp * np.sin(fx * X + channel_phase) * np.sin(
            fy * Y + 1.7 * channel_phase
        )
    return np.clip(v, 0.0, 1.0)


def render_view(K, cam_center, H, W, a=10.0, b=0.25):
    """Render the plane Z = a + b*X from a camera at `cam_center` (world,
    axis-aligned orientation). Returns (img (H, W, 3) f32, depth (H, W))."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    dx = (u - cx) / fx
    dy = (v - cy) / fy
    dz = np.ones_like(dx)
    c = np.asarray(cam_center, np.float64)
    t = (a + b * c[0] - c[2]) / (dz - b * dx)
    Px = c[0] + t * dx
    Py = c[1] + t * dy
    depth = t * dz  # camera-frame Z
    img = np.stack(
        [_texture(Px, Py, p) for p in (0.0, 2.1, 4.2)], axis=-1
    ).astype(np.float32)
    return img, depth.astype(np.float32)


def make_scene_batch(B, H, W, baseline=0.35, affine=False, affine_seed=11):
    """Batch dict for the fused train step: 3 consistent frames + K, with
    per-sample camera offsets. Camera moves along +X by `baseline` per
    frame (frame -1 at -baseline, frame +1 at +baseline).

    With `affine=True` the batch additionally carries the affine-branch keys
    (color_affine_*, Rc, ratio_local, angle, box, valid masks), produced by
    the SAME parameter math and PIL resize/rotate/crop chain as the real
    data pipeline (mono_vifi_tpu_torch.data.mono_dataset, reference
    datasets/mono_dataset.py:96-162) applied to the rendered frames — so the
    SADC/affine-photometric losses see exactly the geometry the trainer
    assumes (reference train.py:814-922).

    Returns (batch, depth0 (B, H, W)) — the true frame-0 depth."""
    K = np.zeros((4, 4), np.float32)
    K[0, 0], K[1, 1] = 0.9 * W, 1.7 * H
    K[0, 2], K[1, 2] = 0.5 * W, 0.5 * H
    K[2, 2] = K[3, 3] = 1.0

    colors = {"n1": [], "0": [], "p1": []}
    depths = []
    for i in range(B):
        ybase = 0.3 * i  # different strip of the plane per sample
        for name, off in (("n1", -baseline), ("0", 0.0), ("p1", baseline)):
            img, depth = render_view(K, (off, ybase, 0.0), H, W)
            colors[name].append(img)
            if name == "0":
                depths.append(depth)

    batch = {"K": np.tile(K, (B, 1, 1)),
             "inv_K": np.tile(np.linalg.pinv(K), (B, 1, 1))}
    for name, lst in colors.items():
        arr = np.stack(lst)
        batch[f"color_{name}"] = arr
        batch[f"color_aug_{name}"] = arr.copy()
    if affine:
        batch.update(
            _affine_keys(colors, B, H, W, batch["K"], batch["inv_K"],
                         seed=affine_seed)
        )
    return batch, np.stack(depths)


def _affine_keys(colors, B, H, W, K, invK, seed):
    """Affine-branch keys via the production dataset machinery: per-sample
    params from MonoDataset._affine_params and images/masks from the exact
    windowed PIL chain (_affine_window/_affine_masks)."""
    from PIL import Image

    from mono_vifi_tpu_torch.data.augment import to_array
    from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset

    ds = MonoDataset("", [], H, W, use_affine=True, is_train=True, seed=seed)
    out = {
        k: []
        for k in (
            "color_affine_n1", "color_affine_0", "color_affine_p1",
            "color_affine_aug_0", "Rc", "ratio_local", "angle", "box",
            "valid_mask_rec", "valid_mask_cons",
        )
    }
    for i in range(B):
        p = ds._affine_params(ds._rng(i), K[i], invK[i])
        for name in ("n1", "0", "p1"):
            pil = Image.fromarray(
                np.clip(colors[name][i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            )
            aff = to_array(ds._affine_window(pil, p))
            out[f"color_affine_{name}"].append(aff)
            if name == "0":
                out["color_affine_aug_0"].append(aff.copy())
        mask_rec, mask_cons = ds._affine_masks(p)
        out["valid_mask_rec"].append(mask_rec)
        out["valid_mask_cons"].append(mask_cons)
        out["Rc"].append(p["Rc"])
        out["ratio_local"].append(np.array([p["ratio"]], np.float32))
        out["angle"].append(np.float32(p["angle"]))
        out["box"].append(p["box"])
    return {k: np.stack(v) for k, v in out.items()}


def median_scaled_abs_rel(pred_depth, gt_depth):
    """Per-batch median-scaled abs_rel (the eigen eval protocol's scaling)."""
    errs = []
    for p, g in zip(pred_depth, gt_depth):
        s = np.median(g) / max(np.median(p), 1e-8)
        ps = np.clip(p * s, 1e-3, 80.0)
        errs.append(np.mean(np.abs(ps - g) / g))
    return float(np.mean(errs))
