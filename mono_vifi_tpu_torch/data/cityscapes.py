"""Cityscapes dataset, evaluation mode (the port's copy of the test branch of
mono_vifi_tpu/data/cityscapes.py; reference datasets/cityscapes_dataset.py):
leftImg8bit_sequence frames with the bottom 25% (ego car) cropped, +/-2
frame neighbours, and per-frame camera json intrinsics."""

from __future__ import annotations

import json
import os

import numpy as np

from mono_vifi_tpu_torch.data.mono_dataset import MonoDataset


class CityscapesDataset(MonoDataset):
    RAW_WIDTH, RAW_HEIGHT = 2048, 1024

    def index_to_folder_and_frame_idx(self, index):
        city, frame_name = self.filenames[index].split()
        return city, frame_name, None

    def load_intrinsics(self, city, frame_name):
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
        return os.path.join(self.data_path, "leftImg8bit_sequence", "test", city,
                            frame_name + "_leftImg8bit.png")

    def get_colors(self, city, frame_name, side):
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
