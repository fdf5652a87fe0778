"""Base monocular dataset, evaluation mode (the port's copy of the
`is_train=False` branch of mono_vifi_tpu/data/mono_dataset.py; reference
datasets/mono_dataset.py).

An item is a dict of float32 numpy arrays:
  color_{n1,0,p1}, color_aug_{n1,0,p1}   (H, W, 3) in [0, 1], NHWC
  K, inv_K                               (4, 4) scale-0 intrinsics
In evaluation nothing is augmented, so color_aug_* equal color_*. A missing
neighbour frame is replaced by the centre frame.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_FRAME_NAME = {-1: "n1", 0: "0", 1: "p1"}


def pil_loader(path: str):
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


def to_array(img) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (ToTensor equivalent, NHWC layout)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class MonoDataset:
    def __init__(self, data_path: str, filenames: Sequence[str], height: int, width: int,
                 frame_idxs: Sequence = (0, -1, 1), num_scales: int = 1,
                 is_train: bool = False, img_ext: str = ".png"):
        if is_train:
            raise NotImplementedError(
                "the training data pipeline is not ported yet (ROADMAP queue 1, item 13)"
            )
        if num_scales != 1:
            raise NotImplementedError("evaluation reads one scale (num_scales=1)")
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_idxs = list(frame_idxs)
        self.img_ext = img_ext
        self.loader = pil_loader

    def __len__(self):
        return len(self.filenames)

    def index_to_folder_and_frame_idx(self, index):
        raise NotImplementedError

    def get_color(self, folder, frame_index, side):
        raise NotImplementedError

    def load_intrinsics(self, folder, frame_index) -> np.ndarray:
        """Normalized 4x4 intrinsics (first row /width, second /height)."""
        return self.K.copy()

    def __getitem__(self, index: int) -> dict:
        from PIL import Image

        folder, frame_index, side = self.index_to_folder_and_frame_idx(index)
        raw = {}  # native-resolution PIL images per frame name
        if hasattr(self, "get_colors"):  # datasets that read all frames at once
            raw.update(self.get_colors(folder, frame_index, side))
        else:
            valid = True
            for i in self.frame_idxs:
                try:
                    raw[_FRAME_NAME[i]] = self.get_color(folder, frame_index + i, side)
                except (FileNotFoundError, OSError):
                    valid = False
            if not valid:  # duplicate the centre for missing neighbours
                raw["n1"] = raw["0"].copy()
                raw["p1"] = raw["0"].copy()

        K = self.load_intrinsics(folder, frame_index).copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        out = {"K": K.astype(np.float32), "inv_K": np.linalg.pinv(K).astype(np.float32)}
        for name, img in raw.items():
            arr = to_array(img.resize((self.width, self.height), Image.LANCZOS))
            out[f"color_{name}"] = arr
            out[f"color_aug_{name}"] = arr
        return out
