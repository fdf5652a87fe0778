"""Whole runs of the tiny copy on the CPU (the chip check skipped): the
result's keys, and `correct` coming out false for the control and for each
fault the cells can have, planted under the timed path."""

from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench import harness, registry

SEED = 2**31 + 977  # more than 32 signed bits hold
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, cell, traced=False, seed=SEED):
    return harness.execute(cell, seed, 1.0, traced, device="cpu", root=root)


def test_untraced_result_keys(tiny_root):
    r = run(tiny_root, "resnet18_kitti_mr.train_mem")
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_traced_result_keys(tiny_root):
    r = run(tiny_root, "resnet18_kitti_mr.video_b1", traced=True)
    assert list(r) == KEYS + ["breakdown", "checks"] and r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    # span readers read on the CPU; device readers find nothing there
    assert {"sf_ms.video", "mf_ms.video", "mfu_pct.video"} <= set(r["metrics"])
    assert "device_idle_pct.video" not in r["metrics"]


def test_no_card_no_result(capsys):
    if harness.torch.cuda.is_available():
        pytest.skip("a card is visible")
    code = harness.main(["--workload", "resnet18_kitti_mr.train_mem", "--seed", "1",
                         "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "no CUDA device" in out.err


def test_control_is_not_correct(tiny_root):
    """The reference with float8 operands in the program's place."""
    cell = registry.find_cell("resnet18_kitti_mr.train_mem", tiny_root)
    drv = registry.driver(cell)
    ctx = harness.Context(cell, SEED, 0.0, False, "cpu", 0.0)
    pool = drv.make_pool(SEED, 3, 2, 64, 96, ctx.device)
    ref = drv.reference_readings(ctx, pool, 3)
    control = drv.reference_readings(ctx, pool, 3, precision="float8")
    from perfbench import compare
    ok, _ = compare.verdict({k: v for k, v in drv.readings(control, ref).items()
                             if not k.startswith("_")}, cell.limits)
    assert not ok


def test_state_left_unchanged_is_not_correct(tiny_root, monkeypatch):
    from mono_vifi_tpu_torch.training import monovifi as M

    def frozen(self):
        def train_step(state, batch, generator=None, noise=None):
            loss, metrics = self.loss_fn(batch, generator, noise, train=True)
            return {k: v.detach() for k, v in metrics.items()}
        return train_step

    monkeypatch.setattr(M.MonoViFiStep, "make_train_step", frozen)
    r = run(tiny_root, "resnet18_kitti_mr.train_mem")
    assert r["correct"] is False and r["checks"]["change_gap"]["value"] > 0.99


def test_half_batch_is_not_correct(tiny_root, monkeypatch):
    from mono_vifi_tpu_torch.training import monovifi as M

    make = M.MonoViFiStep.make_train_step

    def halved(self):
        step = make(self)

        def train_step(state, batch, generator=None, noise=None):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half, generator, noise)
        return train_step

    monkeypatch.setattr(M.MonoViFiStep, "make_train_step", halved)
    assert run(tiny_root, "resnet18_kitti_mr.train_mem")["correct"] is False


def test_altered_answer_is_not_correct(tiny_root, monkeypatch):
    from mono_vifi_tpu_torch.training import monovifi as M

    mf = M.multi_frame_disp

    def altered(bundle, *imgs):
        out = mf(bundle, *imgs).clone()
        out[..., 0, 0] += 0.5
        return out

    monkeypatch.setattr(M, "multi_frame_disp", altered)
    r = run(tiny_root, "resnet18_kitti_mr.video_b1")
    assert r["correct"] is False and np.isclose(r["checks"]["mf_gap"]["value"], 0.5, atol=1e-3)
