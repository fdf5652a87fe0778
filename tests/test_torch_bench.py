"""The port's bench (mono_vifi_tpu_torch.bench) on the CPU, against the root
bench.py: its batch has bench.py's keys and shapes at every size the
configs use (the images and masks uint8, as the data pipeline stages them),
and at 640x192 it is byte for byte the batch the card's smoke script built
before the helper moved into the port; the command line resolves to bench.py's batch
and size table; `run` at a tiny size prints bench.py's record (plus the
MFU against the H100's bf16 peak) as its last line; without a card the
entry point raises."""

import hashlib
import json
import math

import numpy as np
import pytest
import torch

import bench as jbench  # the root bench.py: numpy at import, JAX only in main()
from mono_vifi_tpu_torch import bench
from mono_vifi_tpu_torch.config import Options

# sha256 over the card's smoke script's make_batch(device, 10) at 640x192 as
# it was before the helper moved to mono_vifi_tpu_torch.bench: for each key in
# sorted order, the key, the dtype, the shape and the bytes
MR_BATCH_SHA256 = "73f64111082d385ce117f6bbd0d48b29041e457b4bb55ca72365de3ca572eacb"
RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "tflop_per_step",
               "mfu_vs_989tflops_bf16"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def digest(batch: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        v = batch[k]
        h.update(k.encode())
        h.update(str(v.dtype).encode())
        h.update(str(tuple(v.shape)).encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def test_make_batch_at_640x192_is_the_old_chip_smoke_batch():
    assert digest(bench.make_batch(10, 192, 640, "cpu")) == MR_BATCH_SHA256


@pytest.mark.parametrize("B,H,W", [(10, 192, 640), (4, 320, 1024), (12, 192, 512)],
                         ids=["MR", "HR", "CS"])
def test_make_batch_has_bench_py_keys_and_shapes(B, H, W):
    ref = jbench.make_batch(B, H, W)
    got = bench.make_batch(B, H, W, "cpu")
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert tuple(got[k].shape) == v.shape, k
        if v.ndim == 4:  # images and masks: uint8 staged, dequantized by the step
            assert got[k].dtype == torch.uint8, k
        else:
            assert got[k].dtype == torch.float32, k
    for k in ("K", "inv_K", "Rc", "ratio_local", "box"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    for k in ("valid_mask_rec", "valid_mask_cons"):
        np.testing.assert_array_equal(got[k].numpy() / 255.0, ref[k], err_msg=k)


@pytest.mark.parametrize("argv,backbone,batch,size,remat", [
    ([], "ResNet18", 10, (192, 640), False),
    (["--backbone", "LiteMono"], "LiteMono", 8, (192, 640), False),
    (["--backbone", "DHRNet"], "DHRNet", 6, (192, 640), False),
    (["--hr"], "ResNet18", 4, (320, 1024), True),
    (["--backbone", "DHRNet", "--hr"], "DHRNet", 4, (320, 1024), True),
    (["--batch", "3"], "ResNet18", 3, (192, 640), False),
])
def test_options_resolve_to_bench_py_table(argv, backbone, batch, size, remat):
    """bench.py:87-100: the batch is `--batch`, else 4 with `--hr`, else the
    backbone's KITTI-MR batch; `--hr` is 320x1024 with encoder_remat; the
    step is affine, bf16, shared_encoder, IFRNet-L."""
    cfg = bench.bench_options(argv)
    assert (cfg.backbone, cfg.batch_size, (cfg.height, cfg.width), cfg.encoder_remat) == (
        backbone, batch, size, remat)
    assert (cfg.use_affine, cfg.compute_dtype, cfg.fuse_model_type, cfg.vfi_train_scale,
            cfg.device) == (True, "bfloat16", "shared_encoder", "large", "cuda")


@pytest.mark.parametrize("argv,name", [
    ([], "monovifi_torch_train_samples_per_sec_640x192_bs10_1gpu"),
    (["--hr"], "monovifi_torch_resnet18_train_samples_per_sec_1024x320_bs4_1gpu"),
    (["--backbone", "LiteMono"], "monovifi_torch_litemono_train_samples_per_sec_640x192_bs8_1gpu"),
])
def test_metric_names_mirror_bench_py(argv, name):
    assert bench.metric_name(bench.bench_options(argv), torch.device("cuda")) == name


def test_run_prints_the_record_last_on_the_cpu(capsys):
    cfg = Options(height=64, width=96, batch_size=2, use_affine=True, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_train_scale="tiny",
                  weights_init="scratch", device="cpu")
    rec = bench.run(cfg, "cpu", iters=2, windows=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == rec
    assert "device time not measured" in lines[-2]
    assert RECORD_KEYS <= rec.keys()
    assert rec["metric"] == "monovifi_torch_resnet18_train_samples_per_sec_96x64_bs2_cpu"
    assert rec["unit"] == "samples/s" and rec["device"] == "cpu"
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 20.0)
    assert rec["tflop_per_step"] > 0 and math.isfinite(rec["mfu_vs_989tflops_bf16"])


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
