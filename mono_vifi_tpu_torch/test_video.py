"""Video depth prediction (the port's counterpart of the root test_video.py;
reference test_video.py): single- and multi-frame depth for every frame of
a directory of sorted frames, the neighbours being the adjacent files (the
first and last frames stand in for their missing neighbour):

    python -m mono_vifi_tpu_torch.test_video --image_path frames/ \
        --pretrained_path ckpt.pth [--vfi_scale small] [--weights_dir ./weights] \
        [--save_npy] [--output_path out/] [--device cpu]

Writes <name>_disp_sf.jpeg and <name>_disp_mf.jpeg (magma), with --save_npy
the scaled disparities <name>_disp_{sf,mf}.npy, and demo.gif (frame,
single- and multi-frame disparity stacked). The multi-frame path runs the
frozen IFRNet (`--weights_dir/IFRNet_{S,L}_<tag>.pth`) and the fusion's
table-sample kernel at batch 1. Runs on the card unless `--device cpu` is
given, in f32 with TF32 off like the evaluation.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from mono_vifi_tpu_torch.evaluate_depth import set_f32_math, to_device_images
from mono_vifi_tpu_torch.evaluate_depth_mf import load_model
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.test_simple import load_frame
from mono_vifi_tpu_torch.training.factory import resolve_device
from mono_vifi_tpu_torch.training.monovifi import multi_frame_disp, single_frame_disp
from mono_vifi_tpu_torch.utils.colormap import magma


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="test_video")
    p.add_argument("--image_path", type=str, required=True, help="directory of video frames")
    p.add_argument("--pretrained_path", type=str)
    p.add_argument("--backbone", type=str, default="ResNet18",
                   choices=["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
    p.add_argument("--vfi_scale", type=str, default="small", choices=["small", "large"])
    p.add_argument("--weights_dir", type=str, default="./weights")
    p.add_argument("--vfi_dataset_tag", type=str, default="KITTI", choices=["KITTI", "CS"])
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=100.0)
    p.add_argument("--ext", type=str, default="png")
    p.add_argument("--save_npy", action="store_true")
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(args):
    from PIL import Image

    resolve_device(args.device)
    set_f32_math()
    bundle = load_model(args, args.vfi_dataset_tag)
    paths = sorted(glob.glob(os.path.join(args.image_path, f"*.{args.ext}")))
    if not paths:
        raise FileNotFoundError(f"no *.{args.ext} frames in {args.image_path}")
    out_dir = args.output_path or args.image_path
    os.makedirs(out_dir, exist_ok=True)
    print(f"-> Predicting on {len(paths)} video frames")

    frames = [load_frame(p, args.width, args.height)[0] for p in paths]
    gif_frames = []
    for i, path in enumerate(paths):
        img, prev, nxt = (to_device_images(frames[j][None], bundle.device)
                          for j in (i, max(i - 1, 0), min(i + 1, len(frames) - 1)))
        disp_sf = single_frame_disp(bundle, img)[0, 0].cpu().numpy()
        disp_mf = multi_frame_disp(bundle, prev, img, nxt)[0, 0].cpu().numpy()

        name = os.path.splitext(os.path.basename(path))[0]
        if args.save_npy:
            for tag, d in (("sf", disp_sf), ("mf", disp_mf)):
                scaled, _ = disp_to_depth(d, args.min_depth, args.max_depth)
                np.save(os.path.join(out_dir, f"{name}_disp_{tag}.npy"), np.asarray(scaled))
        row_img = (frames[i] * 255).astype(np.uint8)
        row_sf = magma(disp_sf / (np.percentile(disp_sf, 95) + 1e-8))
        row_mf = magma(disp_mf / (np.percentile(disp_mf, 95) + 1e-8))
        Image.fromarray(row_sf).save(os.path.join(out_dir, f"{name}_disp_sf.jpeg"))
        Image.fromarray(row_mf).save(os.path.join(out_dir, f"{name}_disp_mf.jpeg"))
        gif_frames.append(Image.fromarray(np.concatenate([row_img, row_sf, row_mf], axis=0)))
        print(f"   Processed {i + 1}/{len(paths)}")

    gif_frames[0].save(os.path.join(out_dir, "demo.gif"), save_all=True,
                       append_images=gif_frames[1:], duration=100, loop=0)
    print(f"-> Done! GIF at {os.path.join(out_dir, 'demo.gif')}")


if __name__ == "__main__":
    main(parse_args())
