"""Host-side photometric augmentation (the port's copy of
mono_vifi_tpu/data/augment.py): torchvision-ColorJitter-equivalent
brightness / contrast / saturation / hue jitter on PIL images.

The reference uses torchvision.transforms.ColorJitter with ranges
brightness / contrast / saturation (0.8, 1.2) and hue (-0.1, 0.1)
(datasets/mono_dataset.py:75-85, :254-258): factors drawn uniformly, the
four ops applied in a random order, one jitter shared by every frame of a
sample. The factors and their order come from the same `random.Random`
calls, in the same order, as in the JAX package, and the path is chosen as
there: the `fast` path (cv2) whenever cv2 imports, else the exact PIL path.
PIL is imported where an image is touched, never at import time.
"""

from __future__ import annotations

import random

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

_LUMA = np.array([0.299, 0.587, 0.114], np.float32)  # PIL "L" weights


def _adjust_hue(img, hue_factor: float):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns), torchvision semantics."""
    from PIL import Image

    if abs(hue_factor) < 1e-9:
        return img
    h, s, v = img.convert("HSV").split()
    np_h = np.array(h, dtype=np.uint8)
    np_h = (np_h.astype(np.int16) + int(round(hue_factor * 255.0))) % 256
    h = Image.fromarray(np_h.astype(np.uint8), "L")
    return Image.merge("HSV", (h, s, v)).convert("RGB")


def _fast_hue_rgb(arr_u8: np.ndarray, hue_factor: float) -> np.ndarray:
    """uint8 RGB hue shift through cv2's HSV round trip, in the PIL path's
    0-255 H convention (HSV_FULL); the two HSV quantizations differ by a few
    /255 on a minority of pixels."""
    hsv = cv2.cvtColor(arr_u8, cv2.COLOR_RGB2HSV_FULL)
    h = hsv[..., 0].astype(np.int16)
    hsv[..., 0] = ((h + int(round(hue_factor * 255.0))) % 256).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)


class ColorJitter:
    """One sampled jitter, applicable to many frames (shared augmentation).

    `fast` (default, when cv2 imports): brightness / contrast / saturation as
    vectorized float ops with one final uint8 rounding, hue through cv2's HSV
    round trip; within ~2/255 of the exact PIL path, with the same factors
    and order. `fast=False`: the exact torchvision / PIL pipeline."""

    def __init__(
        self,
        brightness=(0.8, 1.2),
        contrast=(0.8, 1.2),
        saturation=(0.8, 1.2),
        hue=(-0.1, 0.1),
        rng: random.Random | None = None,
        fast: bool = True,
    ):
        r = rng or random
        self.brightness = r.uniform(*brightness)
        self.contrast = r.uniform(*contrast)
        self.saturation = r.uniform(*saturation)
        self.hue = r.uniform(*hue)
        self.order = list(range(4))
        r.shuffle(self.order)
        self.fast = fast and cv2 is not None

    def _pil_op(self, i: int, img):
        from PIL import ImageEnhance

        if i == 0:
            return ImageEnhance.Brightness(img).enhance(self.brightness)
        if i == 1:
            return ImageEnhance.Contrast(img).enhance(self.contrast)
        if i == 2:
            return ImageEnhance.Color(img).enhance(self.saturation)
        return _adjust_hue(img, self.hue)

    def _call_fast(self, img):
        from PIL import Image

        arr = np.asarray(img, np.float32)
        for i in self.order:
            if i == 0:  # brightness: blend toward black
                arr = arr * self.brightness
            elif i == 1:  # contrast: blend toward the mean gray
                gray = arr @ _LUMA
                m = float(np.mean(gray))
                arr = arr * self.contrast + (1.0 - self.contrast) * m
            elif i == 2:  # saturation: blend toward per-pixel gray
                gray = (arr @ _LUMA)[..., None]
                arr = arr * self.saturation + (1.0 - self.saturation) * gray
            else:  # hue: integer HSV round trip on the current uint8 image
                if abs(self.hue) < 1e-9:  # identity (the PIL path skips too)
                    continue
                u8 = np.clip(arr + 0.5, 0, 255).astype(np.uint8)
                arr = _fast_hue_rgb(u8, self.hue).astype(np.float32)
                continue
            # PIL's blend saturates to the uint8 range after every op
            arr = np.clip(arr, 0.0, 255.0)
        return Image.fromarray(np.clip(arr + 0.5, 0, 255).astype(np.uint8))

    def __call__(self, img):
        if self.fast:
            return self._call_fast(img)
        for i in self.order:
            img = self._pil_op(i, img)
        return img


class Identity:
    def __call__(self, img):
        return img


def to_array(img) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (ToTensor equivalent, NHWC layout)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def to_u8(img) -> np.ndarray:
    """PIL -> uint8 HWC. The /255 float conversion runs on the device
    (training.monovifi.dequantize_batch), where f32(u8) / 255 equals
    to_array exactly."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr
