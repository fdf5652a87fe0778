"""Video mixes: single- and multi-frame depth for every frame of a recorded
video, test_video.main's per-frame work, in a closed loop.

Parameters of a mix file (`traffic/<mix>.json`, "driver": "video"):
  frames       frames of the video, made from the seed and held decoded in
               host memory (f32 HWC in [0, 1], as test_simple.load_frame
               returns them); the loop cycles through them
  pan_px       pixels the camera pans between frames
  sample       frames whose disparities are kept and compared
  trace_frames frames of the window's end that the traced run profiles

Per frame: upload the frame and its two neighbours (the first and last
frames stand in for their missing neighbour), `single_frame_disp`,
`multi_frame_disp` (frozen IFRNet at the configuration's `vfi_test_scale`),
both disparities copied to the host; f32 with TF32 off (set_f32_math).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.reference.config import Config
from perfbench.reference.training import factory as ref_factory
from perfbench.reference.training import monovifi as ref_step


def make_video(seed: int, frames: int, H: int, W: int, pan: int) -> list[np.ndarray]:
    """A panning sequence: crops of one textured strip (smooth shading,
    blobs and fine grain) shifted by `pan` pixels a frame."""
    gen = torch.Generator().manual_seed(seed)
    Wt = W + pan * frames
    coarse = F.interpolate(torch.rand((1, 3, H // 24 + 2, Wt // 24 + 2), generator=gen),
                           size=(H, Wt), mode="bicubic", align_corners=False)
    mid = F.interpolate(torch.rand((1, 3, H // 6 + 2, Wt // 6 + 2), generator=gen),
                        size=(H, Wt), mode="bilinear", align_corners=False)
    grain = torch.rand((1, 3, H, Wt), generator=gen)
    strip = (0.6 * coarse + 0.3 * mid + 0.1 * grain).clamp(0, 1)[0].permute(1, 2, 0)
    strip = strip.contiguous().numpy().astype(np.float32)
    return [np.ascontiguousarray(strip[:, i * pan:i * pan + W]) for i in range(frames)]


def sample_frames(seed: int, frames: int, n: int) -> list[int]:
    """`n` distinct frame indices drawn from the seed, the first and last
    frame (which stand in for their own neighbours) among them."""
    rng = np.random.default_rng(seed)
    inner = rng.choice(np.arange(1, frames - 1), size=n - 2, replace=False)
    return sorted({0, frames - 1, *inner.tolist()})


def neighbours(i: int, frames: int) -> tuple[int, int, int]:
    return i, max(i - 1, 0), min(i + 1, frames - 1)


def reference_config(ctx) -> Config:
    """The evaluation's settings: f32 whatever the training computes in."""
    return Config.from_keys({**ctx.cell.config["options"], "compute_dtype": "float32"})


def initial_weights(ctx) -> dict:
    with torch.device("meta"):
        shape = ref_factory.ModelBundle(reference_config(ctx), for_training=False)
    return weights.draw(shape, ctx.seed, ctx.device)


def set_f32_math(tf32: bool = False) -> None:
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32


class Program:
    """The port's evaluation bundle, as test_video builds it, with the
    seed's weights."""

    def __init__(self, ctx):
        from mono_vifi_tpu_torch.config import Options
        from mono_vifi_tpu_torch.evaluate_depth import to_device_images
        from mono_vifi_tpu_torch.training import monovifi as M
        from mono_vifi_tpu_torch.training.factory import ModelBundle

        ctx.phase("import")
        if ctx.device.type == "cuda":
            from mono_vifi_tpu_torch.ops.cuda import build

            build.load()
        ctx.phase("kernel_library")
        o = ctx.cell.config["options"]
        self.ctx = ctx
        set_f32_math()
        # test_video leaves cuDNN's autotuner off
        torch.backends.cudnn.benchmark = False
        opts = Options(backbone=o["backbone"], height=o["height"], width=o["width"],
                       compute_dtype="float32", vfi_test_scale=o["vfi_test_scale"],
                       fuse_model_type=o["fuse_model_type"], device=str(ctx.device))
        with torch.device(ctx.device):
            self.bundle = ModelBundle(opts, for_training=False)
        weights.load(self.bundle, initial_weights(ctx))
        self.to_device = to_device_images
        self.sf, self.mf = M.single_frame_disp, M.multi_frame_disp
        mix = ctx.cell.traffic
        self.video = make_video(ctx.seed, mix["frames"], o["height"], o["width"],
                                mix["pan_px"])
        self.sample = set(sample_frames(ctx.seed, mix["frames"], mix["sample"]))
        self.kept: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.count = 0
        ctx.phase("model_build")

    def frame(self):
        """One frame of the video, the next in the cycle."""
        spans, n = self.ctx.spans, len(self.video)
        i = self.count % n
        self.count += 1
        with spans.span("frame"):
            img, prev, nxt = (self.to_device(self.video[j][None], self.ctx.device)
                              for j in neighbours(i, n))
            with spans.span("sf_call"):
                sf = self.sf(self.bundle, img)[0, 0].cpu().numpy()
            with spans.span("mf_call"):
                mf = self.mf(self.bundle, prev, img, nxt)[0, 0].cpu().numpy()
        if i in self.sample:
            self.kept[i] = (sf, mf)

    def warm_up(self):
        """Every frame once: each shape and the autotuner's choices."""
        self.frame()
        self.ctx.phase("first_step")
        for _ in range(len(self.video) - 1):
            self.frame()
        self.ctx.phase("warm_up")

    def free(self):
        del self.bundle
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_disps(ctx, video, frames: list[int], tf32: bool = False) -> dict:
    """{frame: (single-frame, multi-frame disparity)} of the plain reference
    from the seed's weights, f32 (TF32 as asked)."""
    with torch.device(ctx.device):
        bundle = ref_factory.ModelBundle(reference_config(ctx), for_training=False)
    weights.load(bundle, weights.draw(bundle, ctx.seed, ctx.device))
    set_f32_math(tf32)
    out = {}
    for i in frames:
        img, prev, nxt = (torch.from_numpy(video[j][None]).permute(0, 3, 1, 2)
                          .contiguous().to(ctx.device) for j in neighbours(i, len(video)))
        sf = ref_step.single_frame_disp(bundle, img)[0, 0].cpu().numpy()
        mf = ref_step.multi_frame_disp(bundle, prev, img, nxt)[0, 0].cpu().numpy()
        out[i] = (sf, mf)
    set_f32_math()
    return out


def readings(prog: dict, ref: dict) -> dict[str, float]:
    """The largest absolute gap of a compared frame's single-frame and
    multi-frame disparity (sigmoid outputs in (0, 1))."""
    return {
        "sf_gap": max(float(np.abs(prog[i][0] - ref[i][0]).max()) for i in ref),
        "mf_gap": max(float(np.abs(prog[i][1] - ref[i][1]).max()) for i in ref),
    }


def run(ctx):
    prog = Program(ctx)
    prog.warm_up()
    window = ctx.window(prog.frame, ctx.cell.traffic["trace_frames"])
    ctx.read_memory_peak()
    closed = time.perf_counter()
    frame_s = ctx.spans.durations("frame", since=window.t0)
    timed = frame_s[:window.timed_items]
    kept, video = prog.kept, prog.video
    prog.free()
    del prog
    ref = reference_disps(ctx, video, sorted(kept))
    return {
        "attempted": window.items, "failed": 0,
        "end_to_end": {
            "video_frames_per_s": window.timed_items / window.timed_seconds,
            "video_frame_ms_p95": float(np.percentile(np.array(timed) * 1e3, 95)),
        },
        "readings": readings(kept, ref),
        "window": window,
        "check_s": time.perf_counter() - closed,
    }


def flops_per_item(cell) -> float:
    from perfbench.counts import flops

    return flops.video_frame(cell.config["options"])


def calibration(ctx) -> dict[str, dict]:
    """The compared numbers of one seed for the program over every frame of
    the video once, and for the control (the reference with TF32 on, in the
    program's place); -> {name: readings}."""
    prog = Program(ctx)
    prog.warm_up()
    kept, video = dict(prog.kept), prog.video
    prog.free()
    del prog
    ref = reference_disps(ctx, video, sorted(kept))
    control = reference_disps(ctx, video, sorted(kept), tf32=True)
    return {"program": readings(kept, ref), "control": readings(control, ref)}
