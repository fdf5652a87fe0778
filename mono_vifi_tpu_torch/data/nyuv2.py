"""NYUv2 indoor dataset (the port's copy of mono_vifi_tpu/data/nyuv2.py;
reference datasets/nyuv2_dataset.py): undistorted training frames with a
16-pixel border cropped off, and `.h5` (rgb, depth) test samples cropped to
the standard 561x427 evaluation window. h5py and cv2 are imported where a
file is read."""

from __future__ import annotations

import os

import numpy as np

from mono_vifi_tpu_torch.data.augment import to_array
from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset

CROP = 16

_FX = 5.1885790117450188e02
_FY = 5.1946961112127485e02
_CX = 3.2558244941119034e02
_CY = 2.5373616633400465e02
_DIST = (2.0796615318809061e-01, -5.8613825163911781e-01,
         7.2231363135888329e-04, 1.0479627195765181e-03, 4.9856986684705107e-01)


def h5_loader(path):
    """-> (rgb (H, W, 3) uint8, depth (H, W)) of an NYUv2 `.h5` sample."""
    import h5py

    with h5py.File(path, "r") as h5f:
        rgb = np.array(h5f["rgb"]).transpose(1, 2, 0)
        depth = np.array(h5f["depth"])
    return rgb, depth


class NYUDataset(MonoDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.is_train:
            self.full_res_shape = (480 - 2 * CROP, 640 - 2 * CROP)
        else:
            self.full_res_shape = (427, 561)
        self.K = self._intrinsics()

    def _intrinsics(self):
        h, w = self.full_res_shape
        fx, fy = _FX / w, _FY / h
        if self.is_train:
            cx, cy = (_CX - CROP) / w, (_CY - CROP) / h
        else:
            cx, cy = (_CX - 40) / w, (_CY - 44) / h
        return np.array(
            [[fx, 0, cx, 0], [0, fy, cy, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
        )

    def index_to_folder_and_frame_idx(self, index):
        return self.filenames[index], 0, None

    def _undistort(self, image: np.ndarray) -> np.ndarray:
        import cv2

        kmat = np.array([[_FX, 0, _CX], [0, _FY, _CY], [0, 0, 1]])
        return cv2.undistort(image, kmat, np.array([_DIST]))

    def get_colors(self, line, frame_index, side, do_flip):
        """Training frames: the split line lists the centre and neighbour
        paths in the order [0, -4, -3, -2, -1, 1, 2, 3, 4]."""
        from PIL import Image

        paths = [os.path.join(self.data_path, p) for p in line.split()]
        order = [0, -4, -3, -2, -1, 1, 2, 3, 4]
        name_map = {-1: "n1", 0: "0", 1: "p1"}
        frames = {}
        for pos, fid in enumerate(order):
            if fid not in set(self.frame_idxs):
                continue
            img = self._undistort(np.array(self.loader(paths[pos])))
            if do_flip:
                img = img[:, ::-1]
            h, w, _ = img.shape
            frames[name_map[fid]] = Image.fromarray(img[CROP:h - CROP, CROP:w - CROP])
        return frames

    def load_test_item(self, index):
        """Evaluation sample: (rgb resized to (W, H), float HWC in [0, 1];
        depth (427, 561) f32)."""
        from PIL import Image

        rgb, depth = h5_loader(os.path.join(self.data_path, self.filenames[index]))
        rgb = rgb[44:471, 40:601, :]
        depth = depth[44:471, 40:601]
        img = Image.fromarray(rgb).resize((self.width, self.height), self.interp)
        return to_array(img), depth.astype(np.float32)
