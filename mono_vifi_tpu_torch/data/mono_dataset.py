"""Base monocular dataset (the port's copy of
mono_vifi_tpu/data/mono_dataset.py; reference datasets/mono_dataset.py):
triplet loading, resize, shared color jitter, flip, the intrinsics pyramid
and the affine-augmentation branch, for training and evaluation.

An item is a dict of numpy arrays keyed by flat names (the batch contract of
training.monovifi), equal key for key, dtype for dtype and value for value
to the JAX package's item of the same (seed, epoch, index):

  color_{n1,0,p1}, color_aug_{n1,0,p1}          (H, W, 3)
  K, inv_K                                       (4, 4)  scale-0 intrinsics
  [affine] color_affine_{n1,0,p1}, color_affine_aug_0,
           Rc (3,3), ratio_local (1,), angle (), box (4,),
           valid_mask_rec / valid_mask_cons      (H, W, 1)
  [stereo] stereo_T (4, 4)
  [num_scales>1] color_{name}_s{i}, color_aug_{name}_s{i}  (H/2^i, W/2^i, 3)
           for i in 1..num_scales-1 (each resized from the previous scale,
           reference mono_dataset.py:87-91, :156-162), plus
           color_affine[_aug]_{name}_s{i} under affine, color_affine_aug_{n1,p1}
           at scale 0, and per-scale intrinsics K_s{i} / inv_K_s{i}
  [doj_mask] doj_mask_{n1,0,p1}                  (H, W, 1)
           (+ training with affine: doj_mask_{name}_affine); Cityscapes only.

Images are float32 in [0, 1], or uint8 with `stage_uint8` (masks then at
0 / 255); the device divides by 255 (training.monovifi.dequantize_batch).
In evaluation nothing is augmented, so color_aug_* equal color_*, and a
missing neighbour frame is replaced by the centre frame.

Augmentation draws come from a `random.Random` seeded by (seed, epoch,
index), so any sample is reproducible; call set_epoch() each epoch. PIL is
imported where an image is read, never at import time.
"""

from __future__ import annotations

import math
import random
from typing import Sequence

import numpy as np

from mono_vifi_tpu_torch.data.augment import ColorJitter, Identity, to_array, to_u8

_FRAME_NAME = {-1: "n1", 0: "0", 1: "p1", "s": "s"}


def pil_loader(path: str):
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


class MonoDataset:
    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        frame_idxs: Sequence = (0, -1, 1),
        num_scales: int = 1,
        use_affine: bool = False,
        resize_ratio=(1.2, 2.0),
        rotate_range=(-5, 5),
        is_train: bool = False,
        img_ext: str = ".png",
        seed: int = 1234,
        stage_uint8: bool = False,
    ):
        from PIL import Image

        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.num_scales = num_scales
        self.frame_idxs = list(frame_idxs)
        self.is_train = is_train
        self.img_ext = img_ext
        self.use_affine = use_affine
        self.resize_ratio = resize_ratio
        self.rotate_range = rotate_range
        self.seed = seed
        self.epoch = 0
        self.loader = pil_loader
        self.interp = Image.LANCZOS  # the reference's Image.ANTIALIAS
        self.stage_uint8 = stage_uint8

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.filenames)

    # ------------------------------------------------------------- plumbing
    def _rng(self, index: int) -> random.Random:
        return random.Random((self.seed * 1000003 + self.epoch) * 2654435761 + index)

    def index_to_folder_and_frame_idx(self, index):
        raise NotImplementedError

    def get_color(self, folder, frame_index, side, do_flip):
        raise NotImplementedError

    def load_intrinsics(self, folder, frame_index) -> np.ndarray:
        """Normalized 4x4 intrinsics (first row /width, second /height)."""
        return self.K.copy()

    # -------------------------------------------------------- affine params
    def _affine_params(self, rng: random.Random, K0: np.ndarray, invK0: np.ndarray):
        """Sample the affine augmentation and derive the intrinsic-corrected
        rotation Rc (reference datasets/mono_dataset.py:110-137)."""
        H, W = self.height, self.width
        ratio = rng.uniform(*self.resize_ratio)
        height_re, width_re = int(H * ratio), int(W * ratio)
        w0 = int((width_re - W) * rng.random())
        h0 = int((height_re - H) * rng.random())
        angle = rng.uniform(*self.rotate_range)

        fs = 1.0 / ratio
        a = math.pi / 180.0 * angle
        R = np.array(
            [
                [math.cos(-a), math.sin(a), 0.0],
                [math.sin(-a), math.cos(-a), 0.0],
                [0.0, 0.0, 1.0],
            ],
            np.float32,
        )
        tmp = R @ np.array(
            [-fs * width_re / 2.0, -fs * height_re / 2.0, fs - 1.0], np.float32
        ) + np.array(
            [(width_re / 2.0 - w0) * fs, (height_re / 2.0 - h0) * fs, 0.0], np.float32
        )
        K33, invK33 = K0[:3, :3], invK0[:3, :3]
        Rc = invK33 @ R @ K33
        tmp = invK33 @ tmp
        Rc = Rc.copy()
        Rc[:, 2] += tmp

        x0 = round(w0 / ratio)
        y0 = round(h0 / ratio)
        w = round(W / ratio)
        h = round(H / ratio)
        return {
            "ratio": ratio,
            "size_re": (width_re, height_re),
            "crop": (w0, h0, w0 + W, h0 + H),
            "angle": angle,
            "Rc": Rc.astype(np.float32),
            "box": np.array([x0, y0, w, h], np.float32),
        }

    def _affine_window(self, img, p):
        """The affine chain resize_local -> rotate -> crop evaluated on a
        padded window of the enlarged canvas only: PIL's resize(box=...)
        samples as resize-then-crop does, rotate(center=...) about the
        translated canvas centre reproduces the full-canvas rotation, and
        the padding covers the largest rotation displacement of any crop
        pixel, so every source the crop needs lies inside the window."""
        from PIL import Image

        width_re, height_re = p["size_re"]
        w0, h0, w1, h1 = p["crop"]
        angle = p["angle"]
        cx, cy = width_re / 2.0, height_re / 2.0
        r = max(
            math.hypot(x - cx, y - cy) for x in (w0, w1) for y in (h0, h1)
        )
        pad = (
            int(math.ceil(2.0 * math.sin(math.radians(abs(angle)) / 2.0) * r))
            + 3
        )
        ox, oy = max(w0 - pad, 0), max(h0 - pad, 0)
        ox2, oy2 = min(w1 + pad, width_re), min(h1 + pad, height_re)
        Wn, Hn = img.size
        sx, sy = Wn / width_re, Hn / height_re
        win = img.resize(
            (ox2 - ox, oy2 - oy),
            self.interp,
            box=(ox * sx, oy * sy, ox2 * sx, oy2 * sy),
        )
        win = win.rotate(
            angle, resample=Image.BILINEAR, expand=False,
            center=(cx - ox, cy - oy),
        )
        return win.crop((w0 - ox, h0 - oy, w1 - ox, h1 - oy))

    def _affine_masks(self, p) -> tuple[np.ndarray, np.ndarray]:
        """valid_mask_rec / valid_mask_cons through PIL warps
        (reference datasets/mono_dataset.py:139-149)."""
        from PIL import Image

        W, H = self.width, self.height
        white = Image.new("L", p["size_re"], 255)
        mask_rec = to_array(self._affine_window(white, p))
        mask_rec = (mask_rec > 0).astype(np.float32)

        x0, y0, w, h = (int(v) for v in p["box"])
        rec_img = Image.fromarray((mask_rec[..., 0] * 255).astype(np.uint8))
        small = rec_img.resize((w, h), Image.BILINEAR)
        canvas = Image.new("L", (W, H), 0)
        canvas.paste(small, (x0, y0))
        restored = canvas.rotate(-p["angle"], resample=Image.BILINEAR, expand=False)
        mask_cons = (to_array(restored) > 0).astype(np.float32)
        return mask_rec, mask_cons

    # -------------------------------------------------------------- getitem
    def __getitem__(self, index: int) -> dict:
        rng = self._rng(index)
        do_color_aug = self.is_train and rng.random() > 0.5
        do_flip = self.is_train and rng.random() > 0.5

        folder, frame_index, side = self.index_to_folder_and_frame_idx(index)

        raw: dict = {}  # native-resolution PIL images per frame name
        if hasattr(self, "get_colors"):  # datasets that read all frames at once
            raw.update(self.get_colors(folder, frame_index, side, do_flip))
        else:
            valid = True
            for i in self.frame_idxs:
                if i == "s":
                    other = {"r": "l", "l": "r"}[side]
                    raw["s"] = self.get_color(folder, frame_index, other, do_flip)
                else:
                    try:
                        raw[_FRAME_NAME[i]] = self.get_color(
                            folder, frame_index + i, side, do_flip
                        )
                    except (FileNotFoundError, OSError):
                        valid = False
            if not valid:  # duplicate the centre for missing neighbours
                raw["n1"] = raw["0"].copy()
                raw["p1"] = raw["0"].copy()
        K0 = self.load_intrinsics(folder, frame_index)

        # scale-0 intrinsics (reference :243-252)
        K = K0.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        inv_K = np.linalg.pinv(K).astype(np.float32)

        out = {"K": K.astype(np.float32), "inv_K": inv_K}
        if self.num_scales > 1:
            # per-scale intrinsics with integer-divided dimensions (reference
            # :243-252)
            for s in range(1, self.num_scales):
                Ks = K0.copy()
                Ks[0, :] *= self.width // (2**s)
                Ks[1, :] *= self.height // (2**s)
                out[f"K_s{s}"] = Ks.astype(np.float32)
                out[f"inv_K_s{s}"] = np.linalg.pinv(Ks).astype(np.float32)

        jitter = ColorJitter(rng=rng) if do_color_aug else Identity()
        conv = to_u8 if self.stage_uint8 else to_array

        affine = None
        if self.use_affine and self.is_train:
            affine = self._affine_params(rng, K, inv_K)

        full_pyramid = self.num_scales > 1
        for name, img in raw.items():
            resized = img.resize((self.width, self.height), self.interp)
            out[f"color_{name}"] = conv(resized)
            out[f"color_aug_{name}"] = conv(jitter(resized))
            im = None
            if affine is not None:
                im = self._affine_window(img, affine)
                out[f"color_affine_{name}"] = conv(im)
                if name == "0" or full_pyramid:
                    out[f"color_affine_aug_{name}"] = conv(jitter(im))
            if full_pyramid:
                prev, prev_aff = resized, im
                for s in range(1, self.num_scales):
                    size = (self.width // 2**s, self.height // 2**s)
                    prev = prev.resize(size, self.interp)
                    out[f"color_{name}_s{s}"] = conv(prev)
                    out[f"color_aug_{name}_s{s}"] = conv(jitter(prev))
                    if prev_aff is not None:
                        prev_aff = prev_aff.resize(size, self.interp)
                        out[f"color_affine_{name}_s{s}"] = conv(prev_aff)
                        out[f"color_affine_aug_{name}_s{s}"] = conv(
                            jitter(prev_aff)
                        )

        if affine is not None:
            mask_rec, mask_cons = self._affine_masks(affine)
            if self.stage_uint8:
                # {0, 1} -> {0, 255} uint8: the device /255 restores {0.0, 1.0}
                mask_rec = (mask_rec * 255).astype(np.uint8)
                mask_cons = (mask_cons * 255).astype(np.uint8)
            out.update(
                {
                    "Rc": affine["Rc"],
                    "ratio_local": np.array([affine["ratio"]], np.float32),
                    "angle": np.float32(affine["angle"]),
                    "box": affine["box"],
                    "valid_mask_rec": mask_rec,
                    "valid_mask_cons": mask_cons,
                }
            )

        # dynamic-object masks (reference mono_dataset.py:171-186: scale-0
        # resize always; the affine variants during training)
        if getattr(self, "doj_mask", False):
            doj_raw = self.get_doj_masks(folder, frame_index, do_flip)
            for name, m in doj_raw.items():
                res = m.resize((self.width, self.height), self.interp)
                out[f"doj_mask_{name}"] = conv(res)
                if affine is not None:
                    out[f"doj_mask_{name}_affine"] = conv(
                        self._affine_window(m, affine)
                    )

        if "s" in self.frame_idxs:
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.1
            out["stereo_T"] = stereo_T

        return out
