"""Optical-flow visualization with the Middlebury colour wheel (the port's
copy of mono_vifi_tpu/utils/flow_vis.py; reference flow_vis.py:106-128):
flow (H, W, 2) -> RGB uint8. numpy only."""

from __future__ import annotations

import numpy as np


def _make_colorwheel() -> np.ndarray:
    """Middlebury flow color wheel: (55, 3) RGB rows across 6 hue segments."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    ramps = [
        (RY, 0, 1, False),  # red->yellow
        (YG, 1, 0, True),   # yellow->green
        (GC, 1, 2, False),  # green->cyan
        (CB, 2, 1, True),   # cyan->blue
        (BM, 2, 0, False),  # blue->magenta
        (MR, 0, 2, True),   # magenta->red
    ]
    for n, base, ramp, down in ramps:
        wheel[col : col + n, base] = 255
        vals = np.floor(255 * np.arange(n) / n)
        wheel[col : col + n, ramp] = 255 - vals if down else vals
        col += n
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(flow: np.ndarray, clip_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 visualization."""
    flow = np.asarray(flow, np.float64)
    u, v = flow[..., 0], flow[..., 1]
    if clip_flow is not None:
        u = np.clip(u, 0, clip_flow)
        v = np.clip(v, 0, clip_flow)
    rad = np.sqrt(u**2 + v**2)
    rad_max = rad.max() + 1e-5
    u, v = u / rad_max, v / rad_max

    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(flow.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        img[..., c] = np.floor(255 * col)
    return img
