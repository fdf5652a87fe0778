"""KITTI dataset variants (the port's copy of mono_vifi_tpu/data/kitti.py;
reference datasets/kitti_dataset.py): raw KITTI with velodyne ground truth,
the odometry sequences, and KITTI with the annotated depth maps."""

from __future__ import annotations

import os

import numpy as np

from mono_vifi_tpu_torch.data.kitti_utils import generate_depth_map
from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset

_SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}

# normalized shared intrinsics (reference kitti_dataset.py:23-26)
_K_NORM = np.array(
    [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float32
)

FULL_RES_SHAPE = (1242, 375)


class KITTIDataset(MonoDataset):
    K = _K_NORM
    full_res_shape = FULL_RES_SHAPE

    def index_to_folder_and_frame_idx(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def get_color(self, folder, frame_index, side, do_flip):
        from PIL import Image

        color = self.loader(self.get_image_path(folder, frame_index, side))
        if do_flip:
            color = color.transpose(Image.FLIP_LEFT_RIGHT)
        return color


class KITTIRAWDataset(KITTIDataset):
    """Raw KITTI with velodyne ground truth."""

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder, f"image_0{_SIDE_MAP[side]}/data", f_str)

    def get_depth(self, folder, frame_index, side, do_flip):
        from PIL import Image

        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(
            self.data_path, folder, f"velodyne_points/data/{int(frame_index):010d}.bin"
        )
        depth = generate_depth_map(calib_path, velo, _SIDE_MAP[side])
        # nearest resize to the canonical full-resolution shape
        d = Image.fromarray(depth.astype(np.float32)).resize(  # mode "F"
            self.full_res_shape, Image.NEAREST
        )
        depth = np.asarray(d, dtype=np.float32)
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class KITTIOdomDataset(KITTIDataset):
    """KITTI odometry sequences."""

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:06d}{self.img_ext}"
        return os.path.join(
            self.data_path, f"sequences/{int(folder):02d}", f"image_{_SIDE_MAP[side]}", f_str
        )


class KITTIDepthDataset(KITTIDataset):
    """KITTI with the improved (annotated) ground-truth depth PNGs."""

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder, f"image_0{_SIDE_MAP[side]}/data", f_str)

    def get_depth(self, folder, frame_index, side, do_flip):
        from PIL import Image

        f_str = f"{frame_index:010d}.png"
        depth_path = os.path.join(
            self.data_path, folder, f"proj_depth/groundtruth/image_0{_SIDE_MAP[side]}", f_str
        )
        depth = Image.open(depth_path).resize(self.full_res_shape, Image.NEAREST)
        depth = np.asarray(depth).astype(np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth
