"""Evaluation protocols for KITTI / Cityscapes / NYUv2 / Make3D (the port's
copy of mono_vifi_tpu/evaluation.py; reference evaluate_depth.py /
evaluate_depth_mf.py).

Network inference runs batched on the card; the per-image metric loop
(variable-size ground truths, median scaling, crops) runs on host numpy,
with bilinear align_corners=True upsampling done by the same separable
interpolation matrices as the device resize (ops/image.py, torch
F.interpolate semantics, reference evaluate_depth.py:161).
"""

from __future__ import annotations

import numpy as np

from mono_vifi_tpu_torch.ops.image import _interp_matrix
from mono_vifi_tpu_torch.ops.metrics import compute_depth_errors_np, compute_make3d_errors_np

STEREO_SCALE_FACTOR = 5.4


def resize_np(img: np.ndarray, size: tuple[int, int], align_corners: bool = True,
              mode: str = "bilinear") -> np.ndarray:
    """(H, W) -> size, torch F.interpolate semantics, host numpy."""
    H, W = img.shape
    Ho, Wo = size
    if mode == "nearest":
        # torch 'nearest': floor(i * H / Ho)
        ri = np.minimum((np.arange(Ho) * H // Ho), H - 1)
        ci = np.minimum((np.arange(Wo) * W // Wo), W - 1)
        return img[np.ix_(ri, ci)]
    Mh = _interp_matrix(H, Ho, align_corners)
    Mw = _interp_matrix(W, Wo, align_corners)
    return Mh @ img @ Mw.T


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray) -> np.ndarray:
    """Monodepth v1 flip post-processing (reference evaluate_depth.py:91-101).

    l_disp: (N, H, W) normal prediction; r_disp: (N, H, W) prediction on the
    flipped image, flipped back.
    """
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    l, _ = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    l_mask = (1.0 - np.clip(20 * (l - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def _median_scale(pred, gt, use_stereo):
    if use_stereo:
        return pred * STEREO_SCALE_FACTOR, None
    ratio = np.median(gt) / np.median(pred)
    return pred * ratio, ratio


def _report(errors, ratios, use_stereo, printer=print):
    if not use_stereo and ratios:
        r = np.asarray(ratios)
        med = np.median(r)
        printer(f" Scaling ratios | med: {med:0.3f} | std: {np.std(r / med):0.3f}")
    mean_errors = np.asarray(errors).mean(0)
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
    printer(("{:>8} | " * len(mean_errors)).format(*names[: len(mean_errors)]))
    printer(("{: 8.3f} | " * len(mean_errors)).format(*mean_errors.tolist()))
    return dict(zip(names, mean_errors.tolist()))


def evaluate_kitti(pred_disps: np.ndarray, gt_depths, eval_split: str = "eigen",
                   use_stereo: bool = False, printer=print) -> dict:
    """KITTI eigen / eigen_benchmark protocol (evaluate_depth.py:134-193):
    per-image align_corners=True upsample to the ground truth's resolution,
    Garg crop (eigen) or gt>0 mask, median scaling (or stereo x5.4), clamp
    [1e-3, 80]."""
    MIN_DEPTH, MAX_DEPTH = 1e-3, 80.0
    errors, ratios = [], []
    for i in range(pred_disps.shape[0]):
        gt = np.asarray(gt_depths[i], np.float32)
        gh, gw = gt.shape[:2]
        disp = resize_np(pred_disps[i].astype(np.float64), (gh, gw), True)
        pred = 1.0 / disp
        if eval_split == "eigen":
            mask = (gt > MIN_DEPTH) & (gt < MAX_DEPTH)
            crop = np.zeros_like(mask)
            crop[
                int(0.40810811 * gh) : int(0.99189189 * gh),
                int(0.03594771 * gw) : int(0.96405229 * gw),
            ] = 1
            mask = mask & (crop > 0)
        else:
            mask = gt > 0
        pred, gt = pred[mask], gt[mask]
        pred, ratio = _median_scale(pred, gt, use_stereo)
        if ratio is not None:
            ratios.append(ratio)
        pred = np.clip(pred, MIN_DEPTH, MAX_DEPTH)
        errors.append(compute_depth_errors_np(gt, pred))
    return _report(errors, ratios, use_stereo, printer=printer)


def evaluate_cityscapes(pred_disps: np.ndarray, gt_depths, use_stereo=False,
                        printer=print) -> dict:
    """Cityscapes protocol (evaluate_depth.py:298-358): 75% ego-car crop +
    centre crop [256:, 192:1856]."""
    MIN_DEPTH, MAX_DEPTH = 1e-3, 80.0
    errors, ratios = [], []
    for i in range(pred_disps.shape[0]):
        gt = np.asarray(gt_depths[i], np.float32)
        gh, gw = gt.shape[:2]
        gh = int(round(gh * 0.75))
        gt = gt[:gh]
        disp = resize_np(pred_disps[i].astype(np.float64), (gh, gw), True)
        pred = 1.0 / disp
        gt = gt[256:, 192:1856]
        pred = pred[256:, 192:1856]
        mask = (gt > MIN_DEPTH) & (gt < MAX_DEPTH)
        pred, gt = pred[mask], gt[mask]
        pred, ratio = _median_scale(pred, gt, use_stereo)
        if ratio is not None:
            ratios.append(ratio)
        pred = np.clip(pred, MIN_DEPTH, MAX_DEPTH)
        errors.append(compute_depth_errors_np(gt, pred))
    return _report(errors, ratios, use_stereo, printer=printer)


def evaluate_nyuv2(pred_disps: np.ndarray, gt_depths, printer=print) -> dict:
    """NYUv2 protocol (evaluate_depth.py:248-295): nearest upsample of
    1/disp, mask 0<d<10, median scaling, clamp at 10."""
    errors, ratios = [], []
    for i in range(pred_disps.shape[0]):
        gt = np.asarray(gt_depths[i], np.float32)
        pred = resize_np(1.0 / pred_disps[i], gt.shape, mode="nearest")
        mask = (gt > 0) & (gt < 10)
        pred, gt = pred[mask], gt[mask]
        ratio = np.median(gt) / np.median(pred)
        ratios.append(ratio)
        pred = pred * ratio
        pred[pred > 10] = 10
        errors.append(compute_depth_errors_np(gt, pred))
    return _report(errors, ratios, False, printer=printer)


def evaluate_make3d(pred_disps: np.ndarray, gt_depths, use_stereo=False,
                    printer=print) -> dict:
    """Make3D protocol (evaluate_depth.py:195-246): nearest upsample, mask
    0<d<70, clamp at 70, log10 rmse variant."""
    errors, ratios = [], []
    for i in range(pred_disps.shape[0]):
        gt = np.asarray(gt_depths[i], np.float32)
        pred = resize_np(1.0 / pred_disps[i], gt.shape, mode="nearest")
        mask = (gt > 0) & (gt < 70)
        pred, gt = pred[mask], gt[mask]
        pred, ratio = _median_scale(pred, gt, use_stereo)
        if ratio is not None:
            ratios.append(ratio)
        pred[pred > 70] = 70
        errors.append(compute_make3d_errors_np(gt, pred))
    if not use_stereo and ratios:
        r = np.asarray(ratios)
        med = np.median(r)
        printer(f" Scaling ratios | med: {med:0.3f} | std: {np.std(r / med):0.3f}")
    mean_errors = np.asarray(errors).mean(0)
    names = ("abs_rel", "sq_rel", "rmse", "rmse_log10")
    printer(("{:>8} | " * 4).format(*names))
    printer(("{: 8.3f} | " * 4).format(*mean_errors.tolist()))
    return dict(zip(names, mean_errors.tolist()))
