"""Export ground-truth depths of the KITTI evaluation splits (the port's
counterpart of the root export_gt_depth.py; reference export_gt_depth.py):
writes splits/kitti/<split>/gt_depths.npz from the velodyne scans (eigen)
or the annotated depth PNGs (eigen_benchmark). The trainer's per-epoch KITTI
evaluation reads it.

    python -m mono_vifi_tpu_torch.export_gt_depth --data_path /data/kitti --split eigen
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mono_vifi_tpu_torch.data.kitti_utils import generate_depth_map
from mono_vifi_tpu_torch.evaluate_depth import SPLITS_DIR
from mono_vifi_tpu_torch.utils import readlines


def export_gt_depths_kitti(data_path: str, split: str) -> str:
    """-> the path of the written gt_depths.npz."""
    split_folder = os.path.join(SPLITS_DIR, "kitti", split)
    lines = readlines(os.path.join(split_folder, "test_files.txt"))

    print(f"Exporting ground truth depths for {split}")
    gt_depths = []
    for line in lines:
        folder, frame_id, _ = line.split()
        frame_id = int(frame_id)
        if split == "eigen":
            calib_dir = os.path.join(data_path, folder.split("/")[0])
            velo = os.path.join(data_path, folder, f"velodyne_points/data/{frame_id:010d}.bin")
            gt_depth = generate_depth_map(calib_dir, velo, 2, True)
        elif split == "eigen_benchmark":
            from PIL import Image

            gt_path = os.path.join(data_path, folder, "proj_depth", "groundtruth", "image_02",
                                   f"{frame_id:010d}.png")
            gt_depth = np.asarray(Image.open(gt_path)).astype(np.float32) / 256.0
        else:
            raise ValueError(f"unsupported split {split}")
        gt_depths.append(gt_depth.astype(np.float32))

    out = os.path.join(split_folder, "gt_depths.npz")
    print(f"Saving to {out}")
    np.savez_compressed(out, data=np.array(gt_depths, dtype=object))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description="export_gt_depth")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--split", type=str, required=True, choices=["eigen", "eigen_benchmark"])
    args = p.parse_args()
    export_gt_depths_kitti(args.data_path, args.split)
