"""The port's loader benchmarks (mono_vifi_tpu_torch.bench_loader and
bench_e2e) against the JAX package's tools (tools/bench_loader.py,
tools/bench_e2e.py), on the CPU: the same noise tree, the same stage keys,
the same first batch bit for bit, the e2e record's keys at a small size,
and the card-less modes and refusals."""

import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from mono_vifi_tpu_torch import bench_e2e as BE
from mono_vifi_tpu_torch import bench_loader as BL
from mono_vifi_tpu_torch.config import Options
from tools import bench_e2e as JBE
from tools import bench_loader as JBL

SMALL = (124, 38)  # (W, H) of the test trees' frames; the loaders resize to 640x192
E2E_KEYS = {"metric", "value", "unit", "steps", "workers", "dispatch_fraction"}
STAGE_KEYS = {"decode_3_frames_ms", "resize_to_640x192_ms", "color_jitter_ms",
              "affine_full_chain_ms", "affine_windowed_ms", "affine_masks_ms",
              "full_getitem_ms"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_bench")
    BL.make_kitti_dir(str(root), size=SMALL)
    return str(root)


def json_lines(text: str) -> list:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def test_make_kitti_dir_matches_the_jax_tool(tmp_path):
    port, ref = tmp_path / "port", tmp_path / "jax"
    BL.make_kitti_dir(str(port), n_frames=4, size=SMALL)
    JBL.make_kitti_dir(str(ref), n_frames=4, size=SMALL)
    files = sorted(p.relative_to(port) for p in port.rglob("*.png"))
    assert files == sorted(p.relative_to(ref) for p in ref.rglob("*.png"))
    assert len(files) == 4
    for f in files:
        a, b = np.asarray(Image.open(port / f)), np.asarray(Image.open(ref / f))
        assert a.shape == (SMALL[1], SMALL[0], 3)
        np.testing.assert_array_equal(a, b)


def test_bench_stages_has_the_jax_tools_keys(tree):
    stages = BL.bench_stages(tree)
    assert set(stages) == STAGE_KEYS
    assert all(math.isfinite(v) and v > 0 for v in stages.values()), stages


@pytest.mark.parametrize("stage_uint8", [True, False])
@pytest.mark.parametrize("workers", [1, 2])
def test_first_batch_matches_the_jax_tool(tree, stage_uint8, workers):
    port = next(iter(BE.build_loader(tree, 2, workers, n_files=30, stage_uint8=stage_uint8)))
    ref = next(iter(JBE.build_loader(tree, 2, workers, n_files=30, stage_uint8=stage_uint8)))
    assert set(port) == set(ref)
    for k, v in ref.items():
        assert port[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_bench_loader_main_prints_the_stages_and_both_rates(capsys):
    BL.main(["--samples", "4", "--workers", "2", "--batch_size", "2"])
    lines = json_lines(capsys.readouterr().out)
    assert [r["metric"] for r in lines] == ["getitem_stage_ms"] + ["loader_samples_per_sec"] * 2
    assert set(lines[0]) == STAGE_KEYS | {"metric", "cpu_count"}
    assert [r["use_affine"] for r in lines[1:]] == [True, False]
    for r in lines[1:]:
        assert r["value"] > 0 and r["workers"] == 2 and r["cpu_count"] >= 1


def test_bench_e2e_record_on_the_cpu(tree, capsys):
    """The e2e loop at a small configuration: 2 steps, batch 2, 64x96, f32,
    tiny VFI; the record (the JAX tool's keys and `device`) is the last
    line, after the timing line with both losses."""
    cfg = Options(height=64, width=96, batch_size=2, backbone="ResNet18", use_affine=True,
                  compute_dtype="float32", fuse_model_type="shared_encoder",
                  vfi_train_scale="tiny", vfi_test_scale="tiny", weights_init="scratch",
                  device="cpu")
    rec = BE.bench_e2e(tree, 2, 2, 2, device="cpu", cfg=cfg)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == rec
    assert set(rec) == E2E_KEYS | {"device"}
    assert rec["metric"] == "monovifi_torch_e2e_train_samples_per_sec_96x64"
    assert rec["steps"] == 2 and rec["workers"] == 2 and rec["device"] == "cpu"
    assert rec["value"] > 0 and 0 < rec["dispatch_fraction"] <= 1
    losses = out[-2].split("; loss ")[1].split(";")[0].split(" -> ")
    assert all(math.isfinite(float(v)) for v in losses), out[-2]
    assert "data wait" in out[-2] and "os.cpu_count()" in out[-2]


def test_the_e2e_configuration_is_the_jax_tools():
    cfg = BE.e2e_options()
    assert (cfg.height, cfg.width, cfg.batch_size, cfg.backbone) == (192, 640, 10, "ResNet18")
    assert cfg.use_affine and cfg.compute_dtype == "bfloat16"
    assert (cfg.fuse_model_type, cfg.weights_init) == ("shared_encoder", "scratch")
    assert BE.STEPS_PER_EPOCH == 3981


def test_loader_only_needs_no_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    BE.main(["--loader-only", "--workers", "2", "--batch", "4", "--keep-dir", str(tmp_path)])
    (rec,) = json_lines(capsys.readouterr().out)
    assert set(rec) == {"metric", "value", "unit", "workers", "stage_uint8", "cpu_count"}
    assert rec["metric"] == "loader_samples_per_sec" and rec["value"] > 0
    assert (rec["workers"], rec["stage_uint8"]) == (2, True)
    assert len(list(tmp_path.rglob("*.png"))) == 24  # kept


def test_e2e_mode_refuses_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BE.main(["--steps", "2", "--keep-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # refused before writing the tree
