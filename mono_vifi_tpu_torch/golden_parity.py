"""Golden-number parity check against the reference (BASELINE.md): the
port's counterpart of tools/golden_parity.py.

The north-star parity criterion: KITTI eigen abs_rel and δ<1.25 (`a1`)
within 0.001 of the PyTorch reference's own `evaluate_depth.py` on the
released checkpoints. It needs the KITTI raw eigen and eigen_benchmark
test frames, their `gt_depths.npz` (export_gt_depth.py) and the released
checkpoints:

    # single-frame (reads the reference .pth or a JAX weight-only .pkl)
    python -m mono_vifi_tpu_torch.golden_parity --kitti_path /data/kitti \
        --ckpt ResNet18_KITTI_MR.pth --backbone ResNet18 --golden golden.json

    # multi-frame (evaluate_depth_mf; IFRNet_S_KITTI.pth in --weights_dir)
    python -m mono_vifi_tpu_torch.golden_parity --kitti_path /data/kitti \
        --ckpt ResNet18_KITTI_MR.pth --mf --weights_dir ./weights --golden golden.json

Golden numbers come from one of two sources, checked in this order before
anything of the port runs:
  1. --golden golden.json: metrics recorded from a run of the reference's
     evaluate_depth.py, shaped {"eigen": {"abs_rel": ..., "a1": ...},
     "eigen_benchmark": {...}};
  2. --run_reference: run the reference's evaluate_depth.py (or
     evaluate_depth_mf.py with --mf) from --reference as a child process on
     the same data and checkpoint, and parse its printed metric rows.
     --reference names the reference repository's checkout; it has no
     default, and --run_reference without it is a usage error (exit 2).

The port's numbers come from `mono_vifi_tpu_torch.evaluate_depth` (or
`evaluate_depth_mf` with --mf), whose `main` returns its metrics per split.
Both read the split files from the module constant `SPLITS_DIR`
(`<repo>/splits`); `evaluate_depth_mf` holds its own copy of it, so a
caller that evaluates other split files sets `SPLITS_DIR` on both modules.
Runs on the card unless `--device cpu` is given.

Exit code 0 = every compared metric within --tolerance (default 0.001, per
BASELINE.json), 1 = any miss, 2 = no golden source.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

METRICS = ("abs_rel", "a1")  # the BASELINE.json parity pair
ALL_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")
SPLITS = ("eigen", "eigen_benchmark")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kitti_path", required=True)
    p.add_argument("--ckpt", required=True, help="reference .pth or a JAX weight-only .pkl")
    p.add_argument("--backbone", default="ResNet18",
                   choices=["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
    p.add_argument("--mf", action="store_true",
                   help="multi-frame protocol (evaluate_depth_mf)")
    p.add_argument("--vfi_scale", default="small", choices=["small", "large"])
    p.add_argument("--weights_dir", default="./weights")
    p.add_argument("--post_process", action="store_true")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--golden", type=str,
                   help="json of recorded reference metrics per split")
    p.add_argument("--run_reference", action="store_true",
                   help="run the reference's evaluation at --reference as the golden source")
    p.add_argument("--reference",
                   help="the reference repository's checkout (needed by --run_reference)")
    p.add_argument("--tolerance", type=float, default=0.001)
    p.add_argument("--save", type=str, help="write both metric sets to this json")
    p.add_argument("--device", type=str, default="cuda")
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def run_ours(args) -> dict:
    """The port's evaluation of --ckpt on KITTI, in-process -> {split:
    metrics} for eigen and eigen_benchmark."""
    argv = ["--pretrained_path", args.ckpt, "--backbone", args.backbone,
            "--kitti_path", args.kitti_path, "--batch_size", str(args.batch_size),
            "--num_workers", str(args.num_workers), "--device", args.device]
    if args.mf:
        from mono_vifi_tpu_torch import evaluate_depth_mf as ev

        argv += ["--weights_dir", args.weights_dir, "--vfi_scale", args.vfi_scale]
    else:
        from mono_vifi_tpu_torch import evaluate_depth as ev

        if args.post_process:
            argv.append("--post_process")
    results = ev.main(ev.eval_args(argv))
    return {split: results[split] for split in SPLITS}


def run_reference(args) -> dict:
    """Run the reference's evaluate_depth.py (or evaluate_depth_mf.py) from
    --reference and parse its printed metric rows: the 7 metrics in
    ALL_NAMES order on the line after an 'abs_rel' header, one row per
    split, eigen first (reference evaluate_depth.py:192-193)."""
    script = "evaluate_depth_mf.py" if args.mf else "evaluate_depth.py"
    cmd = [sys.executable, os.path.join(args.reference, script),
           "--pretrained_path", args.ckpt, "--backbone", args.backbone,
           "--kitti_path", args.kitti_path, "--batch_size", str(args.batch_size)]
    if args.post_process and not args.mf:
        cmd.append("--post_process")
    print(f"-> running reference: {' '.join(cmd)}")
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=args.reference)
    if out.returncode != 0:
        print(out.stdout[-2000:])
        print(out.stderr[-2000:])
        raise RuntimeError(f"reference eval failed (rc={out.returncode})")
    rows = re.findall(r"abs_rel[^\n]*\n[^\d\-]*((?:[-\d.]+\s*[|&]?\s*){7})", out.stdout)
    golden = {}
    for split, row in zip(SPLITS, rows):
        golden[split] = dict(zip(ALL_NAMES, (float(v) for v in re.findall(r"[-\d.]+", row))))
    if not golden:
        print(out.stdout[-2000:])
        raise RuntimeError("could not parse reference metric rows")
    return golden


def compare(ours: dict, golden: dict, tolerance: float) -> bool:
    """Print one PASS/FAIL line per METRICS entry of each golden split;
    -> whether all are within `tolerance` and no golden split is missing."""
    ok = True
    print(f"\n== parity vs golden (tolerance {tolerance}) ==")
    for split, gvals in golden.items():
        if split not in ours:
            print(f"  {split}: MISSING from our run")
            ok = False
            continue
        for m in METRICS:
            if m not in gvals:
                continue
            d = abs(ours[split][m] - gvals[m])
            verdict = "PASS" if d <= tolerance else "FAIL"
            ok &= verdict == "PASS"
            print(f"  {split:16s} {m:8s} ours={ours[split][m]:.4f} "
                  f"golden={gvals[m]:.4f} |Δ|={d:.4f}  {verdict}")
    return ok


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.golden:
        with open(args.golden) as f:
            golden = json.load(f)
    elif args.run_reference:
        if not args.reference:
            parser.error("--run_reference needs --reference, the reference "
                         "repository's checkout")
        golden = run_reference(args)
    else:
        print("No golden source: pass --golden metrics.json or "
              "--run_reference (needs CUDA torch).")
        return 2

    ours = run_ours(args)
    ok = compare(ours, golden, args.tolerance)
    if args.save:
        with open(args.save, "w") as f:
            json.dump({"ours": ours, "golden": golden,
                       "tolerance": args.tolerance, "pass": ok}, f, indent=2)
        print(f"-> wrote {args.save}")
    print("\nRESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
