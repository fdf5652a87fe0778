"""Depth evaluation metrics (counterpart of mono_vifi_tpu/ops/metrics.py;
reference layers.py:293-311): a torch function for metrics on the device,
and numpy twins for the host-side metric loops over variable-size ground
truths (the protocols resize each prediction to its ground truth's own
resolution, evaluate_depth.py:160-162).
"""

from __future__ import annotations

import numpy as np
import torch


def compute_depth_errors(gt, pred):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3 over flattened valid
    pixels, as 0-d tensors."""
    thresh = torch.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).float().mean()
    a2 = (thresh < 1.25**2).float().mean()
    a3 = (thresh < 1.25**3).float().mean()

    rmse = torch.sqrt(((gt - pred) ** 2).mean())
    rmse_log = torch.sqrt(((torch.log(gt) - torch.log(pred)) ** 2).mean())
    abs_rel = (torch.abs(gt - pred) / gt).mean()
    sq_rel = ((gt - pred) ** 2 / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def compute_depth_errors_np(gt: np.ndarray, pred: np.ndarray):
    """Numpy twin of compute_depth_errors for host-side eval loops."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = float((thresh < 1.25).mean())
    a2 = float((thresh < 1.25**2).mean())
    a3 = float((thresh < 1.25**3).mean())

    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log = float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean()))
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean((gt - pred) ** 2 / gt))
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


def compute_make3d_errors_np(gt: np.ndarray, pred: np.ndarray):
    """Make3D protocol errors (reference evaluate_depth.py:73-88)."""
    abs_rel = float(np.mean(np.abs(gt - pred) / gt))
    sq_rel = float(np.mean(((gt - pred) ** 2) / gt))
    rmse = float(np.sqrt(((gt - pred) ** 2).mean()))
    rmse_log10 = float(np.sqrt((np.abs(np.log10(gt) - np.log10(pred)) ** 2).mean()))
    return abs_rel, sq_rel, rmse, rmse_log10
