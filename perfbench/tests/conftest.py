"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations and mixes are cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import registry

TINY = {"height": 64, "width": 96, "batch_size": 2, "vfi_train_scale": "tiny",
        "vfi_test_scale": "tiny"}
# limits of the tiny copy's cells, between what its sound runs read on
# the CPU (seeds 2**31 + 977 and 6, the reference in the configuration's
# bf16: first step's loss 0, worst leaf's first gradient 2.1e-4-3.4e-4,
# worst leaf's change 8.7e-3-1.2e-2; disparities 6e-8) and what the control
# and the planted faults read (float8: first loss 5.4e-6 and up, gradient
# 0.18 and up; half batch: first loss 3.1e-4, gradient 0.58; state
# unchanged 1.0; altered answer 0.5)
TINY_LIMITS = {"loss_gap_first": 2e-6, "grad_gap": 0.02, "change_gap": 0.3,
               "sf_gap": 1e-5, "mf_gap": 1e-5}


def copy_benchmark(dest: Path) -> Path:
    shutil.copytree(registry.ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", dest)
    return dest


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory) -> Path:
    root = copy_benchmark(tmp_path_factory.mktemp("tiny"))
    for f in (root / "perfbench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["options"].update(TINY)
        f.write_text(json.dumps(c))
    for f in (root / "perfbench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update({k: v for k, v in {"frames": 8, "trace_frames": 2, "trace_steps": 1}.items()
                  if k in t})
        f.write_text(json.dumps(t))
    for f in (root / "perfbench" / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["limits"] = {k: TINY_LIMITS[k] for k in w["limits"] if k in TINY_LIMITS}
        f.write_text(json.dumps(w))
    return root


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 4))
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """Skips a test that needs the card where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
