"""Make3D evaluation reader (the port's copy of mono_vifi_tpu/data/make3d.py;
reference datasets/make3d_dataset.py): Test134 JPEGs with the (0, 710,
1704, 1562) centre crop, and the `.mat` laser depth, rows 17:38. PIL and
scipy are imported where a file is read."""

from __future__ import annotations

import os

import numpy as np

from mono_vifi_tpu_torch.data.augment import to_array


class Make3DDataset:
    def __init__(self, data_path, filenames, input_resolution=None):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.input_resolution = input_resolution  # (H, W)

    def __len__(self):
        return len(self.filenames)

    def __getitem__(self, index):
        from PIL import Image, ImageFile
        from scipy.io import loadmat

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        line = self.filenames[index]
        color_path = os.path.join(self.data_path, "Test134", f"img-{line}.jpg")
        depth_path = os.path.join(self.data_path, "Gridlaserdata", f"depth_sph_corr-{line}.mat")
        img = Image.open(color_path).convert("RGB").crop((0, 710, 1704, 1562))
        if self.input_resolution is not None:
            h, w = self.input_resolution
            img = img.resize((w, h), Image.LANCZOS)
        depth = loadmat(depth_path)["Position3DGrid"][:, :, 3][17:38, :]
        return {"color": to_array(img), "depth": depth.astype(np.float32)}
