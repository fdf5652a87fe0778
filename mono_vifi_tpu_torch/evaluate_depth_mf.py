"""Multi-frame (fused) depth evaluation (the port's counterpart of
evaluate_depth_mf.py; reference evaluate_depth_mf.py).

Loads encoder_mf / depth_mf / fusion_module from a checkpoint and the frozen
IFRNet (small | large) from --weights_dir, runs VFI flows (only_flow) -> one
encoder pass over the three frames -> fusion through the table-sample
kernel -> depth decoder, and evaluates KITTI (eigen and eigen_benchmark)
and/or Cityscapes with the standard protocols. Runs on the card unless
`--device cpu` is given:

    python -m mono_vifi_tpu_torch.evaluate_depth_mf --pretrained_path ckpt.pth \
        --kitti_path /data/kitti [--vfi_scale small] [--device cpu]

Like the JAX entry point it evaluates in f32 (TF32 off).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mono_vifi_tpu_torch import evaluation
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.evaluate_depth import (
    SPLITS_DIR, load_pretrained, set_f32_math, to_device_images,
)
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import build_bundle, resolve_device
from mono_vifi_tpu_torch.training.monovifi import multi_frame_disp
from mono_vifi_tpu_torch.utils import count_params, flops, readlines


def eval_args(argv=None):
    p = argparse.ArgumentParser(description="Multi-frame Evaluation Parser")
    p.add_argument("--pretrained_path", type=str)
    p.add_argument("--backbone", type=str, default="ResNet18",
                   choices=["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
    p.add_argument("--vfi_scale", type=str, default="small", choices=["small", "large"])
    p.add_argument("--weights_dir", type=str, default="./weights")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=100.0)
    p.add_argument("--kitti_path", type=str)
    p.add_argument("--cityscapes_path", type=str)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_model(args, dataset_tag: str):
    """Build the evaluation bundle (frozen IFRNet at --vfi_scale) on
    `args.device`, load the checkpoint's multi-frame roles and the VFI."""
    cfg = Options(backbone=args.backbone, height=args.height, width=args.width,
                  compute_dtype="float32", vfi_test_scale=args.vfi_scale,
                  fuse_model_type="shared_encoder")
    bundle = build_bundle(cfg, seed=0, device=args.device, for_training=False)
    if args.pretrained_path:
        load_pretrained(args.pretrained_path, bundle, multi_frame=True)
    tag = "S" if args.vfi_scale == "small" else "L"
    vfi_path = os.path.join(args.weights_dir, f"IFRNet_{tag}_{dataset_tag}.pth")
    if os.path.exists(vfi_path):
        print(f"-> Loading frozen VFI from {vfi_path}")
        ckpt_lib.load_vfi(vfi_path, bundle)
    else:
        print(f"!! VFI weights not found at {vfi_path}; using random init")
    n = count_params(bundle.encoder, bundle.depth_mf, bundle.fusion_module)
    print(f"  depth+fusion params: {n / 1e6:.2f} M")

    # FLOPs with per-video amortization (reference evaluate_depth_mf.py
    # :136-156): in streaming video each frame is encoded once, so the
    # three-frame encoder cost amortizes to one encoder + VFI + fusion
    img = torch.ones((1, 3, args.height, args.width), device=bundle.device)
    embt = torch.full((1, 1, 1, 1), 0.5, device=bundle.device)
    f_enc = flops(bundle.encoder.eval(), img)
    f_vfi = flops(lambda a, b: bundle.vfi_test(a, b, embt, only_flow=True), img, img)
    f_full = flops(lambda a, b, c: multi_frame_disp(bundle, a, b, c), img, img, img)
    print(f"  flops: full {f_full / 1e9:.2f} G | encoder {f_enc / 1e9:.2f} G | "
          f"VFI(onlyFlow) {f_vfi / 1e9:.2f} G | amortized/frame "
          f"{(f_full - 2 * f_enc) / 1e9:.2f} G")
    return bundle


def predict_disps_mf(args, bundle, batches) -> np.ndarray:
    """Run the fused network over an iterable of batches (dicts holding
    NHWC `color_n1`, `color_0`, `color_p1`) -> (N, H, W) scaled disparities."""
    device = bundle.device
    disps = []
    for batch in batches:
        imgs = [to_device_images(batch[k], device) for k in ("color_n1", "color_0", "color_p1")]
        disp, _ = disp_to_depth(multi_frame_disp(bundle, *imgs), args.min_depth, args.max_depth)
        disps.append(disp[:, 0].cpu().numpy())
    return np.concatenate(disps, 0)


def main(args) -> dict:
    """Evaluate on KITTI and/or Cityscapes; -> {split: metrics} (`eigen`,
    `eigen_benchmark`, `cityscapes`)."""
    from mono_vifi_tpu_torch.data import CityscapesDataset, DataLoader, KITTIRAWDataset

    results = {}
    resolve_device(args.device)
    set_f32_math()
    if args.kitti_path:
        bundle = load_model(args, "KITTI")
        for split in ("eigen", "eigen_benchmark"):
            print(f" Evaluate on KITTI (multi-frame) with {split} split:")
            files = readlines(os.path.join(SPLITS_DIR, "kitti", split, "test_files.txt"))
            ds = KITTIRAWDataset(args.kitti_path, files, args.height, args.width, [0, -1, 1], 1)
            loader = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                                drop_last=False)
            gt = np.load(os.path.join(SPLITS_DIR, "kitti", split, "gt_depths.npz"),
                         fix_imports=True, encoding="latin1", allow_pickle=True)["data"]
            pred = predict_disps_mf(args, bundle, loader)
            results[split] = evaluation.evaluate_kitti(pred, gt, split, use_stereo=False)

    if args.cityscapes_path:
        bundle = load_model(args, "CS")
        print(" Evaluate on Cityscapes (multi-frame):")
        files = readlines(os.path.join(SPLITS_DIR, "cityscapes", "test_files.txt"))
        ds = CityscapesDataset(args.cityscapes_path, files, args.height, args.width,
                               [0, -1, 1], 1)
        loader = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                            drop_last=False)
        gt_path = os.path.join(SPLITS_DIR, "cityscapes", "gt_depths")
        gts = [np.load(os.path.join(gt_path, str(i).zfill(3) + "_depth.npy"))
               for i in range(len(ds))]
        pred = predict_disps_mf(args, bundle, loader)
        results["cityscapes"] = evaluation.evaluate_cityscapes(pred, gts, use_stereo=False)
    return results


if __name__ == "__main__":
    main(eval_args())
