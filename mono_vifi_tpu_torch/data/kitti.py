"""KITTI raw dataset, evaluation mode (the port's copy of
mono_vifi_tpu/data/kitti.py `KITTIRAWDataset`; reference
datasets/kitti_dataset.py). Ground truths come from the split's
gt_depths.npz, so the velodyne reader is not needed here."""

from __future__ import annotations

import os

import numpy as np

from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset

_SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}

# normalized shared intrinsics (reference kitti_dataset.py:23-26)
_K_NORM = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
)


class KITTIRAWDataset(MonoDataset):
    K = _K_NORM

    def index_to_folder_and_frame_idx(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder, f"image_0{_SIDE_MAP[side]}/data", f_str)

    def get_color(self, folder, frame_index, side):
        return self.loader(self.get_image_path(folder, frame_index, side))
