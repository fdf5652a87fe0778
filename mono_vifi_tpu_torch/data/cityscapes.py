"""Cityscapes dataset (the port's copy of mono_vifi_tpu/data/cityscapes.py;
reference datasets/cityscapes_dataset.py).

Training reads the preprocessed vertical 3-frame concatenations (see
prepare_cityscapes.py) at 1024x384 with per-sequence cam.txt intrinsics,
optionally with dynamic-object masks; evaluation reads leftImg8bit_sequence
frames with the bottom 25% (ego car) cropped, +/-2 frame neighbours and the
per-frame camera json intrinsics.
"""

from __future__ import annotations

import json
import os

import numpy as np

from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset


class CityscapesDataset(MonoDataset):
    def __init__(self, *args, doj_mask: bool = False, mask_dir: str | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        if self.is_train:
            self.RAW_WIDTH, self.RAW_HEIGHT = 1024, 384
        else:
            self.RAW_WIDTH, self.RAW_HEIGHT = 2048, 1024
        # optional dynamic-object masks (reference cityscapes_dataset.py:137-161)
        self.doj_mask = doj_mask
        self.mask_dir = mask_dir or ("./train_mask" if self.is_train else "./val_mask")

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def load_intrinsics(self, city, frame_name):
        if self.is_train:
            camera_file = os.path.join(self.data_path, city, f"{frame_name}_cam.txt")
            camera = np.loadtxt(camera_file, delimiter=",")
            fx, fy, u0, v0 = camera[0], camera[4], camera[2], camera[5]
            K = np.array([[fx, 0, u0, 0], [0, fy, v0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                         np.float32)
            K[0, :] /= self.RAW_WIDTH
            K[1, :] /= self.RAW_HEIGHT
            return K
        camera_file = os.path.join(self.data_path, "camera", "test", city,
                                   frame_name + "_camera.json")
        with open(camera_file) as f:
            camera = json.load(f)["intrinsic"]
        K = np.array(
            [[camera["fx"], 0, camera["u0"], 0], [0, camera["fy"], camera["v0"], 0],
             [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float32,
        )
        K[0, :] /= self.RAW_WIDTH
        K[1, :] /= self.RAW_HEIGHT * 0.75  # bottom-25% crop
        return K

    @staticmethod
    def _offset_framename(frame_name, offset):
        city, seq, num = frame_name.split("_")
        return f"{city}_{seq}_{str(int(num) + offset).zfill(6)}"

    def get_image_path(self, city, frame_name):
        if self.is_train:
            return os.path.join(self.data_path, city, f"{frame_name}.png")
        return os.path.join(self.data_path, "leftImg8bit_sequence", "test", city,
                            frame_name + "_leftImg8bit.png")

    def get_colors(self, city, frame_name, side, do_flip):
        from PIL import Image

        if self.is_train:
            color = np.array(self.loader(self.get_image_path(city, frame_name)))
            h = color.shape[0] // 3
            frames = {
                "n1": Image.fromarray(color[:h]),
                "0": Image.fromarray(color[h:2 * h]),
                "p1": Image.fromarray(color[2 * h:]),
            }
            if do_flip:
                frames = {k: v.transpose(Image.FLIP_LEFT_RIGHT) for k, v in frames.items()}
            return frames

        def load_crop(name):
            img = self.loader(self.get_image_path(city, name))
            w, h = img.size
            return img.crop((0, 0, w, h * 3 // 4))

        frames = {"0": load_crop(frame_name)}
        valid = True
        for offset, key in ((-2, "n1"), (2, "p1")):
            try:
                frames[key] = load_crop(self._offset_framename(frame_name, offset))
            except (FileNotFoundError, OSError):
                valid = False
        if not valid:
            frames["n1"] = frames["0"].copy()
            frames["p1"] = frames["0"].copy()
        return frames

    def get_doj_masks(self, city, frame_name, do_flip):
        """Native-resolution dynamic-object mask images keyed by frame name
        (reference cityscapes_dataset.py:137-161); MonoDataset.__getitem__
        resizes them, and warps them through the affine chain in training."""
        from PIL import Image

        c, seq, frame = frame_name.split("_")
        frame = int(frame)
        out = {}
        for suffix, key in (("", "0"), ("-1", "n1"), ("+1", "p1")):
            mask = np.load(os.path.join(self.mask_dir, f"{c}_{seq}_{frame}{suffix}.npy"))
            if mask.dtype != np.uint8:  # float / bool masks -> 0 / 255 uint8
                mask = (mask > 0).astype(np.uint8) * 255
            img = Image.fromarray(mask)
            if do_flip:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            out[key] = img
        return out
