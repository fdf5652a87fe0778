"""Device time of the table-sample kernel (`bilinear_sample_table`,
csrc/fwarp.cu) at the shapes of its paths: the five fusion levels of the
training step (60 uses of 30 planes, bf16) and the multi-frame inference
shape (8 uses of 12 planes, f32), with chip_smoke.py's inputs. Each time is
one launch's share of 20 launches captured in a CUDA graph (best of 5
replays), so the host's launch cost is left out. Needs a CUDA card; from
the repository root:

    python3 time_table_sample.py [CHECKOUT]

CHECKOUT (default: this one) is the root of the checkout whose
`mono_vifi_tpu_torch` is timed, so that two commits can be compared on one
card: unpack the other with `git archive` into `_checkout/` (which
.gitignore lists) and run both in turns, A B B A. A checkout whose table
sample takes the six factor planes (ly, lx, a0, a1, c0, c1) in place of the
coordinates is given those, built before the timed launches.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import chip_smoke as CS


def main() -> int:
    checkout = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
    sys.path.insert(0, str(checkout))
    import inspect

    import torch

    from mono_vifi_tpu_torch.ops import sampling
    from mono_vifi_tpu_torch.ops.cuda import fwarp as FW
    from mono_vifi_tpu_torch.training.monovifi import TABLE_USES

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    coords = "gx" in inspect.signature(FW.bilinear_sample_table).parameters
    H, W, B, BI = CS.H, CS.W, CS.B, CS.BI
    cases = [(B, TABLE_USES, torch.bfloat16, C, h, w)
             for C, h, w in ((64, H // 2, W // 2), (64, H // 4, W // 4),
                             (128, H // 8, W // 8), (256, H // 16, W // 16),
                             (512, H // 32, W // 32))]
    cases.append((BI, (0, 2), torch.float32, 64, H // 2, W // 2))
    rows = []
    for b, uses, dt, C, h, w in cases:
        U, N = 3 * b, len(uses) * b
        ids = torch.tensor([q * b + j for q in uses for j in range(b)],
                           dtype=torch.int32, device=dev)
        table = torch.randn((U, C, h, w), generator=gen, device=dev).to(dt)
        gx, gy = sampling.flow_to_grid(CS.smooth_flow(
            gen, N, h, w, 10.0 * w / (W // 2), 4.0 * h / (H // 2), dev))
        gx, gy = gx.contiguous(), gy.contiguous()
        if coords:
            args = (table, ids, gx, gy)
        else:
            f = [t.contiguous() for t in sampling.border_factors((h, w), gx, gy)]
            args = (table, ids, *f)
        ms = CS.graph_ms(lambda: FW.bilinear_sample_table(*args))
        shape = f"{N} uses of {U} planes ({C}, {h}, {w}) {str(dt)[6:]}"
        print(f"{shape}: device_ms {ms:.4f}", flush=True)
        rows.append({"shape": shape, "device_ms": ms})
    print(json.dumps({"checkout": str(checkout), "takes_coordinates": coords,
                      "table_sample": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
