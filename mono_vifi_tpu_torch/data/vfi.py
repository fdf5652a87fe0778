"""Triplet datasets of IFRNet VFI training (the port's copy of
mono_vifi_tpu/data/vfi.py; reference datasets/VFI_dataset.py): three
consecutive frames resized to (W, H) with PIL, and in training a random
crop (KITTI 160x576, Cityscapes 176x480), channel reversal, vertical and
horizontal flips and time reversal. An item is float32 HWC frames in [0, 1]
(`img0`, `img1` the middle frame, `img2`) and `embt` = 0.5, equal to the JAX
package's item of the same (seed, epoch, index): the draws come from the
same per-item `random.Random`."""

from __future__ import annotations

import os
import random

import numpy as np

_SIDE_MAP = {"2": 2, "3": 3, "l": 2, "r": 3}


def _resize(img, width: int, height: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(img.resize((width, height), Image.BILINEAR), dtype=np.uint8)


def _load_resized(path: str, width: int, height: int) -> np.ndarray:
    from PIL import Image

    return _resize(Image.open(path).convert("RGB"), width, height)


def _augment_triplet(img0, img1, img2, crop_hw, rng: random.Random):
    h, w = crop_hw
    ih, iw, _ = img0.shape
    x = rng.randint(0, ih - h)
    y = rng.randint(0, iw - w)
    img0, img1, img2 = (im[x:x + h, y:y + w] for im in (img0, img1, img2))
    if rng.random() < 0.5:  # reverse channels
        img0, img1, img2 = (im[:, :, ::-1] for im in (img0, img1, img2))
    if rng.random() < 0.3:  # vertical flip
        img0, img1, img2 = (im[::-1] for im in (img0, img1, img2))
    if rng.random() < 0.5:  # horizontal flip
        img0, img1, img2 = (im[:, ::-1] for im in (img0, img1, img2))
    if rng.random() < 0.5:  # time reversal
        img0, img2 = img2, img0
    return img0, img1, img2


class _VFIDataset:
    crop_hw = (160, 576)

    def __init__(self, data_path, filenames, height, width, is_train=False,
                 img_ext=".png", seed: int = 1234):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.is_train = is_train
        self.img_ext = img_ext
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.filenames)

    def _rng(self, index):
        return random.Random((self.seed * 1000003 + self.epoch) * 2654435761 + index)

    def _triplet(self, index):
        raise NotImplementedError

    def __getitem__(self, index):
        img0, img1, img2 = self._triplet(index)
        if self.is_train:
            img0, img1, img2 = _augment_triplet(img0, img1, img2, self.crop_hw,
                                                self._rng(index))
        return {
            "img0": np.ascontiguousarray(img0, np.float32) / 255.0,
            "img1": np.ascontiguousarray(img1, np.float32) / 255.0,
            "img2": np.ascontiguousarray(img2, np.float32) / 255.0,
            "embt": np.float32(0.5),
        }


class KITTIVFIDataset(_VFIDataset):
    """Lines `folder frame side`: frames frame-1, frame, frame+1 of
    folder/image_0{2,3}/data."""

    crop_hw = (160, 576)

    def _triplet(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        base = os.path.join(self.data_path, folder, f"image_0{_SIDE_MAP[side]}/data")
        return tuple(
            _load_resized(os.path.join(base, f"{frame_index + o:010d}{self.img_ext}"),
                          self.width, self.height)
            for o in (-1, 0, 1)
        )


class CityscapesVFIDataset(_VFIDataset):
    """Lines `city frame`: the preprocessed city/frame.png, three frames
    stacked vertically."""

    crop_hw = (176, 480)

    def _triplet(self, index):
        from PIL import Image

        city, frame_name = self.filenames[index].split()
        arr = np.asarray(Image.open(
            os.path.join(self.data_path, city, f"{frame_name}.png")).convert("RGB"),
            dtype=np.uint8)
        h = arr.shape[0] // 3
        return tuple(_resize(Image.fromarray(arr[i * h:(i + 1) * h]), self.width,
                             self.height) for i in range(3))
