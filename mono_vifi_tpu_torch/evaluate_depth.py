"""Single-frame depth evaluation (the port's counterpart of evaluate_depth.py;
reference evaluate_depth.py).

Evaluates a checkpoint on KITTI (eigen and eigen_benchmark), Make3D, NYU
Depth v2 and/or Cityscapes, gated by which --*_path flags are set. Reads
reference `.pth` checkpoints and the JAX package's weight-only `.pkl`
snapshots. Runs on the card unless `--device cpu` is given:

    python -m mono_vifi_tpu_torch.evaluate_depth --pretrained_path ckpt.pth \
        --kitti_path /data/kitti [--post_process] [--use_stereo] [--device cpu]

Like the JAX entry point it evaluates in f32: TF32 is turned off for cuDNN
convolutions and for matrix products.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np
import torch

from mono_vifi_tpu_torch import evaluation
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import build_bundle, resolve_device
from mono_vifi_tpu_torch.training.monovifi import prepare_batch, single_frame_disp
from mono_vifi_tpu_torch.utils import count_params, flops, readlines

SPLITS_DIR = str(Path(__file__).resolve().parents[1] / "splits")


def eval_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluation Parser")
    p.add_argument("--pretrained_path", type=str)
    p.add_argument("--backbone", type=str, default="ResNet18",
                   choices=["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=100.0)
    p.add_argument("--post_process", action="store_true")
    p.add_argument("--use_stereo", action="store_true")
    p.add_argument("--kitti_path", type=str)
    p.add_argument("--make3d_path", type=str)
    p.add_argument("--nyuv2_path", type=str)
    p.add_argument("--cityscapes_path", type=str)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def set_f32_math() -> None:
    """Evaluate in true f32, as the JAX entry points do: a cuDNN f32
    convolution otherwise runs in TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(" TF32 off for cuDNN convolutions and matrix products: f32 evaluation")


def load_pretrained(path, bundle, multi_frame=False):
    """A reference `.pth` or a JAX weight-only `.pkl` into `bundle`."""
    print(f"-> Loading weights from {path}")
    if path.endswith(".pth"):
        ckpt_lib.load_reference_pth(path, bundle, multi_frame)
    else:
        ckpt_lib.load_jax_weights(path, bundle)


def load_model(args):
    """Build the evaluation bundle on `args.device` and load its weights."""
    cfg = Options(backbone=args.backbone, height=args.height, width=args.width,
                  compute_dtype="float32", num_scales=1)
    bundle = build_bundle(cfg, seed=0, device=args.device, for_training=False)
    if args.pretrained_path:
        load_pretrained(args.pretrained_path, bundle)
    n_params = count_params(bundle.encoder, bundle.depth)
    img = torch.ones((1, 3, args.height, args.width), device=bundle.device)
    f = flops(lambda x: single_frame_disp(bundle, x), img)
    print(f"\n  flops: {f / 1e9:.2f} G, params: {n_params / 1e6:.2f} M\n")
    return bundle


def to_device_images(img, device) -> torch.Tensor:
    """An NHWC uint8 or float batch -> NCHW f32 on `device`, in [0, 1]."""
    return prepare_batch({"img": img}, device)["img"]


def predict_disps(args, bundle, images_iter) -> np.ndarray:
    """Run the network over an iterable of (B, H, W, 3) arrays -> (N, H, W)
    scaled disparities, with optional flip post-processing."""
    device = bundle.device
    disps = []
    for img in images_iter:
        n = img.shape[0]
        x = to_device_images(img, device)
        if args.post_process:
            x = torch.cat([x, x.flip(3)], 0)
        disp, _ = disp_to_depth(single_frame_disp(bundle, x), args.min_depth, args.max_depth)
        disp = disp[:, 0].cpu().numpy()
        if args.post_process:
            disp = evaluation.batch_post_process_disparity(disp[:n], disp[n:][:, :, ::-1])
        disps.append(disp)
    return np.concatenate(disps, 0)


def main(args) -> dict:
    """Evaluate on every dataset whose --*_path is set; -> {split: metrics}
    (`eigen`, `eigen_benchmark`, `make3d`, `nyuv2`, `cityscapes`)."""
    from mono_vifi_tpu_torch.data import (
        CityscapesDataset, DataLoader, KITTIRAWDataset, Make3DDataset, NYUDataset,
    )

    results = {}
    resolve_device(args.device)
    set_f32_math()
    bundle = load_model(args)
    print(f" Evaluated at resolution {args.height} * {args.width}")
    print(" Post-process is used" if args.post_process else " No post-process")
    if args.use_stereo:
        print(f" Stereo evaluation - scaling by {evaluation.STEREO_SCALE_FACTOR}")
    else:
        print(" Mono evaluation - using median scaling\n")

    if args.kitti_path:
        for split in ("eigen", "eigen_benchmark"):
            print(f" Evaluate on KITTI with {split} split:")
            files = readlines(os.path.join(SPLITS_DIR, "kitti", split, "test_files.txt"))
            ds = KITTIRAWDataset(args.kitti_path, files, args.height, args.width, [0], 1)
            loader = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                                drop_last=False)
            gt = np.load(os.path.join(SPLITS_DIR, "kitti", split, "gt_depths.npz"),
                         fix_imports=True, encoding="latin1", allow_pickle=True)["data"]
            pred = predict_disps(args, bundle, (b["color_0"] for b in loader))
            results[split] = evaluation.evaluate_kitti(pred, gt, split, args.use_stereo)

    if args.make3d_path:
        print(" Evaluate on Make3D:")
        files = readlines(os.path.join(SPLITS_DIR, "make3d", "test_files.txt"))
        ds = Make3DDataset(args.make3d_path, files, (args.height, args.width))
        items = [ds[i] for i in range(len(ds))]
        pred = predict_disps(args, bundle, (it["color"][None] for it in items))
        results["make3d"] = evaluation.evaluate_make3d(
            pred, [it["depth"] for it in items], args.use_stereo)

    if args.nyuv2_path:
        print(" Evaluate on NYU Depth v2:")
        files = readlines(os.path.join(SPLITS_DIR, "nyuv2", "test_files.txt"))
        ds = NYUDataset(args.nyuv2_path, files, args.height, args.width, [0], 1)
        items = [ds.load_test_item(i) for i in range(len(ds))]
        pred = predict_disps(args, bundle, (rgb[None] for rgb, _ in items))
        results["nyuv2"] = evaluation.evaluate_nyuv2(pred, [depth for _, depth in items])

    if args.cityscapes_path:
        print(" Evaluate on Cityscapes:")
        files = readlines(os.path.join(SPLITS_DIR, "cityscapes", "test_files.txt"))
        ds = CityscapesDataset(args.cityscapes_path, files, args.height, args.width, [0], 1)
        loader = DataLoader(ds, args.batch_size, num_workers=args.num_workers,
                            drop_last=False)
        gt_path = os.path.join(SPLITS_DIR, "cityscapes", "gt_depths")
        gts = [np.load(os.path.join(gt_path, str(i).zfill(3) + "_depth.npy"))
               for i in range(len(ds))]
        pred = predict_disps(args, bundle, (b["color_0"] for b in loader))
        results["cityscapes"] = evaluation.evaluate_cityscapes(pred, gts, args.use_stereo)
    return results


if __name__ == "__main__":
    main(eval_args())
