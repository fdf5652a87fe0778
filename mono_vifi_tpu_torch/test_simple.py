"""Single-image depth prediction (the port's counterpart of the root
test_simple.py; reference test_simple.py):

    python -m mono_vifi_tpu_torch.test_simple --image_path img.png \
        --pretrained_path ckpt.pth [--backbone ResNet18] [--save_npy] [--device cpu]

`--image_path` is an image or a directory of `*.<ext>` images. Writes
<name>_disp.jpeg (the magma colormap of the disparity resized to the
image's own size) and, with --save_npy, <name>_disp.npy (the scaled
disparity at the network's resolution) beside the images. Runs on the card
unless `--device cpu` is given, in f32 with TF32 off like the evaluation.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from mono_vifi_tpu_torch.evaluate_depth import load_model, set_f32_math, to_device_images
from mono_vifi_tpu_torch.evaluation import resize_np
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.training.factory import resolve_device
from mono_vifi_tpu_torch.training.monovifi import single_frame_disp
from mono_vifi_tpu_torch.utils.colormap import magma


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="test_simple")
    p.add_argument("--image_path", type=str, required=True,
                   help="image file or directory of images")
    p.add_argument("--pretrained_path", type=str)
    p.add_argument("--backbone", type=str, default="ResNet18",
                   choices=["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--min_depth", type=float, default=0.1)
    p.add_argument("--max_depth", type=float, default=100.0)
    p.add_argument("--ext", type=str, default="png")
    p.add_argument("--save_npy", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_frame(path: str, width: int, height: int):
    """-> (the image resized to (width, height) with LANCZOS as f32 HWC in
    [0, 1], its original (W, H))."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    x = img.resize((width, height), Image.LANCZOS)
    return np.asarray(x, np.float32) / 255.0, img.size


def main(args):
    from PIL import Image

    resolve_device(args.device)
    set_f32_math()
    bundle = load_model(args)
    if os.path.isfile(args.image_path):
        paths = [args.image_path]
        out_dir = os.path.dirname(args.image_path)
    else:
        paths = sorted(glob.glob(os.path.join(args.image_path, f"*.{args.ext}")))
        out_dir = args.image_path
    print(f"-> Predicting on {len(paths)} test images")

    for idx, path in enumerate(paths):
        x, (w0, h0) = load_frame(path, args.width, args.height)
        disp = single_frame_disp(bundle, to_device_images(x[None], bundle.device))
        disp = disp[0, 0].cpu().numpy()
        name = os.path.splitext(os.path.basename(path))[0]
        if args.save_npy:
            scaled, _ = disp_to_depth(disp, args.min_depth, args.max_depth)
            np.save(os.path.join(out_dir, f"{name}_disp.npy"), np.asarray(scaled))
        # to the original resolution, align_corners=False as the reference
        disp_full = resize_np(disp.astype(np.float64), (h0, w0), align_corners=False)
        rgb = magma(disp_full / (np.percentile(disp_full, 95) + 1e-8))
        Image.fromarray(rgb).save(os.path.join(out_dir, f"{name}_disp.jpeg"))
        print(f"   Processed {idx + 1} of {len(paths)} images - saved predictions")
    print("-> Done!")


if __name__ == "__main__":
    main(parse_args())
