"""Synthetic-scene convergence smoke of the port (the counterpart of
tools/convergence_smoke.py).

Trains the whole fused Mono-ViFI step on the analytic multi-view-consistent
scene of mono_vifi_tpu_torch.synthetic_scene and reports whether (a) the
photometric loss falls and (b) the median-scaled depth error against the
known ground truth improves: training works, through the hand-written
kernels on the card, without KITTI.

    python -m mono_vifi_tpu_torch.convergence_smoke [--steps 300]
        [--size 96x320] [--batch 2] [--dtype bfloat16] [--affine]
        [--log-every 25] [--device cuda]

The step runs on the card; `--device cpu` runs it on the CPU with the
kernels' plain versions. The JAX tool's `--no-fast-warp` has no
counterpart: `fast_warp` has no effect in the port (mono_vifi_tpu_torch.
config). Prints one JSON line with the first and last tenths' mean
`loss_base` and the initial and final abs_rel (and, with `--affine`, the
SADC term's). `run(trace_every=N)` also returns the run's trajectory, a row
every N steps, and `run(init=fn)` starts from weights `fn` loads into the
bundle (the JAX package's init, in tests/test_torch_convergence.py).

The weights start from the port's own random init from the seed, not the
JAX package's: the two differ, and the port's starts at a near-constant
disparity whose median-scaled abs_rel on this plane is already low, so the
depth error has less to improve than in the JAX run (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import sys


def run(steps=120, H=96, W=320, B=2, compute_dtype="bfloat16", lr=2e-4, seed=0,
        log_every=0, use_affine=False, fuse_model_type="shared_all", device="cuda",
        trace_every=0, init=None) -> dict:
    """The JAX tool's run. With `trace_every` > 0 the result also holds
    "trace": rows [step, abs_rel, least and largest eval-mode disparity,
    mean loss_base over the steps since the last row] at step 0 and every
    `trace_every` steps. `init`, when given, is called with the train
    state's bundle before the first step (to load other weights)."""
    import numpy as np
    import torch

    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
    from mono_vifi_tpu_torch.synthetic_scene import make_scene_batch, median_scaled_abs_rel
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.training.factory import resolve_device

    dev = resolve_device(device)
    cfg = Options(
        height=H, width=W, batch_size=B, use_affine=use_affine,
        compute_dtype=compute_dtype, fuse_model_type=fuse_model_type,
        vfi_train_scale="tiny", vfi_test_scale="tiny",
        learning_rate=lr, lr_sche_type="step", decay_step=(10**6,),
        weights_init="scratch", device=str(dev),
    )
    state = M.create_train_state(cfg, seed, steps_per_epoch=max(steps, 1), device=dev)
    if init is not None:
        init(state.bundle)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    np_batch, gt_depth = make_scene_batch(B, H, W, affine=use_affine)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in np_batch.items()}
    x = M.prepare_batch({"x": np_batch["color_0"]}, dev)["x"]

    def depth_row(step):
        disp = M.single_frame_disp(state.bundle, x)
        _, depth = disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        err = median_scaled_abs_rel(depth[:, 0].float().cpu().numpy(), gt_depth)
        return [step, err, float(disp.min()), float(disp.max())]

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    losses, sadc = [], []
    trace = [depth_row(0) + [None]]
    for i in range(steps):
        metrics = train_step(state, batch, gen)
        losses.append(float(metrics["loss_base"]))
        if use_affine:
            sadc.append(float(metrics["loss_sadc"]))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss_base {losses[-1]:.4f}", file=sys.stderr)
        if trace_every and (i + 1) % trace_every == 0:
            trace.append(depth_row(i + 1) + [float(np.mean(losses[-trace_every:]))])
    err0 = trace[0][1]
    err1 = trace[-1][1] if trace[-1][0] == steps else depth_row(steps)[1]
    k = max(len(losses) // 10, 1)

    def mean(v):
        return float(np.mean(v)) if v else float("nan")

    out = {
        "steps": steps,
        "fast_warp": cfg.fast_warp,
        "compute_dtype": compute_dtype,
        "use_affine": use_affine,
        "loss_first10": mean(losses[:k]),
        "loss_last10": mean(losses[-k:]),
        "abs_rel_initial": err0,
        "abs_rel_final": err1,
    }
    if use_affine:
        out["sadc_first10"] = mean(sadc[:k])
        out["sadc_last10"] = mean(sadc[-k:])
    if trace_every:
        out["trace"] = trace
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Synthetic-scene convergence smoke of the port")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", default="96x320")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--affine", action="store_true")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    H, W = (int(v) for v in args.size.split("x"))
    out = run(steps=args.steps, H=H, W=W, B=args.batch, compute_dtype=args.dtype,
              log_every=args.log_every, use_affine=args.affine, device=args.device)
    print(json.dumps({"metric": "convergence_smoke", **out}))


if __name__ == "__main__":
    main()
