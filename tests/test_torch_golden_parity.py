"""`python -m mono_vifi_tpu_torch.golden_parity` against the JAX package's
tools/golden_parity.py, on the CPU, on a synthetic KITTI tree
(`mono_vifi_tpu_torch.data.synthetic.write_kitti_tree`: two test lines of
1242x375 frames with sparse synthetic ground truths; an `eigen_benchmark`
split beside its `eigen` with the same lines and ground truths, since the
protocol applies that split's gt>0 mask itself):

  - `run_ours`, single-frame with and without `--post_process` and `--mf`,
    reports the JAX tool's metrics per split (all seven, rtol 1e-4);
  - `main`'s exit codes (2 with no golden source, before any evaluation,
    and for `--run_reference` without `--reference`; 0 within the
    tolerance; 1 for a miss or a golden split ours lacks) and its `--save`
    file;
  - `run_reference` parses a stand-in reference script's rows (the
    reference's `&` format and the port's `|` format) as the JAX tool does,
    and raises where the script fails.

Both sides evaluate the same seeded random weights: the port from a
reference `.pth` (and `weights_dir/IFRNet_S_KITTI.pth`), the root scripts
through the JAX package's converter in place of their `load_model` (which
builds the whole training bundle op by op, about a minute on a CPU). Their
disparities differ by ~1e-6, hence rtol 1e-4 on the metrics, the
tolerance of tests/test_torch_readers.py. The `eval_args` of both
packages' entry modules are wrapped to append `--height 96 --width 320`,
to keep the JAX package's CPU compiles cheap; the full 640x192 runs on the
card, in tests/test_torch_card.py.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import evaluate_depth as JED
import evaluate_depth_mf as JEDM
from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu_torch import evaluate_depth as ED
from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
from mono_vifi_tpu_torch import golden_parity as GP
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.data.synthetic import write_kitti_tree
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import build_bundle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 320
SIZE = ["--height", str(H), "--width", str(W)]


def _load_jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_parity", os.path.join(ROOT, "tools", "golden_parity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JGP = _load_jax_tool()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other heavy files of the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """-> (kitti_path, splits root) of a synthetic drive with eigen and
    eigen_benchmark test splits of two lines."""
    root = tmp_path_factory.mktemp("tree")
    splits = write_kitti_tree(str(root), n_frames=4, n_test=2)
    shutil.copytree(os.path.join(splits, "kitti", "eigen"),
                    os.path.join(splits, "kitti", "eigen_benchmark"))
    return str(root / "kitti"), splits


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """-> (checkpoint path, weights_dir, the JAX side's single-frame and
    multi-frame `load_model` results) of one seeded evaluation bundle."""
    root = tmp_path_factory.mktemp("weights")
    cfg = Options(height=H, width=W, compute_dtype="float32", vfi_test_scale="small")
    src = build_bundle(cfg, 17, "cpu", for_training=False)
    rng = np.random.default_rng(12)
    for m in src.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    ckpt = root / "model_0.pth"
    ckpt_lib.save_weights(str(ckpt), src, cfg)
    torch.save({"VFI": src.vfi_test.state_dict()}, root / "IFRNet_S_KITTI.pth")

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    enc = jconvert.convert_depth_encoder(sd(src.encoder), 18)
    depth = jconvert.convert_depth_decoder(sd(src.depth))["params"]
    depth_mf = jconvert.convert_depth_decoder(sd(src.depth_mf))["params"]
    bstats = {"encoder": enc["batch_stats"]}
    jb = JM.ModelBundle(JOptions(height=H, width=W, compute_dtype="float32",
                                 vfi_test_scale="small", vfi_train_scale="tiny",
                                 weights_init="scratch"))
    single = (jb, {"encoder": enc["params"], "depth": depth}, bstats)
    # the multi-frame roles on the slots the root load_model gives them
    multi = (jb, {"encoder": enc["params"], "depth": depth_mf, "depth_mf": depth_mf,
                  "fusion_module": jconvert.convert_fusion_module(
                      sd(src.fusion_module))["params"]},
             bstats, jconvert.convert_ifrnet(sd(src.vfi_test))["params"])
    return str(ckpt), str(root), single, multi


@pytest.fixture()
def setup(tree, weights, monkeypatch):
    """The split files of `tree` in both packages' entry modules, their
    `eval_args` at 96x320, the root scripts' `load_model` by the converted
    weights. -> argv of golden_parity for the tree and the checkpoint."""
    kitti, splits = tree
    ckpt, weights_dir, single, multi = weights
    for mod in (ED, EDM, JED, JEDM):
        monkeypatch.setattr(mod, "SPLITS_DIR", splits)
        parse = mod.eval_args
        monkeypatch.setattr(mod, "eval_args", lambda argv, parse=parse: parse(argv + SIZE))
    monkeypatch.setattr(JED, "load_model", lambda args: single)
    # the root evaluate_depth_mf.load_model raises UnboundLocalError (pinned in
    # tests/test_torch_entries.py), so the JAX tool's --mf cannot run without this
    monkeypatch.setattr(JEDM, "load_model", lambda args, tag: multi)
    return ["--kitti_path", kitti, "--ckpt", ckpt, "--weights_dir", weights_dir,
            "--num_workers", "1"]


def _args(argv):
    """The same namespace for both tools (the JAX tool parses inside its
    `main`; the port's flags are its flags plus `--device`)."""
    return GP.parse_args(argv + ["--device", "cpu"])


def assert_same_metrics(got, ref, what):
    assert set(got) == set(ref) == set(GP.SPLITS), what
    for split in ref:
        assert got[split].keys() == ref[split].keys() == set(GP.ALL_NAMES)
        for k in ref[split]:
            np.testing.assert_allclose(got[split][k], ref[split][k], rtol=1e-4,
                                       err_msg=f"{what} {split} {k}")


@pytest.fixture(scope="module")
def jax_single():
    """The JAX tool's single-frame metrics, filled by the first test that
    runs it."""
    return {}


@pytest.mark.parametrize("extra", [[], ["--post_process"]], ids=["plain", "post_process"])
def test_run_ours_single_frame_matches_the_jax_tool(setup, extra, jax_single):
    args = _args(setup + extra)
    ref = JGP.run_ours(argparse.Namespace(**vars(args)))
    jax_single[tuple(extra)] = ref
    got = GP.run_ours(args)
    assert_same_metrics(got, ref, f"single-frame {extra}")
    assert all(np.isfinite(v) for m in got.values() for v in m.values())


def test_run_ours_multi_frame_matches_the_jax_tool(setup):
    args = _args(setup + ["--mf"])
    ref = JGP.run_ours(argparse.Namespace(**vars(args)))
    got = GP.run_ours(args)
    assert_same_metrics(got, ref, "multi-frame")


def _golden(jax_single, setup):
    if () not in jax_single:  # this test alone: the JAX tool's numbers now
        jax_single[()] = JGP.run_ours(argparse.Namespace(**vars(_args(setup))))
    return json.loads(json.dumps(jax_single[()]))


def test_no_golden_source_exits_2_before_evaluating(setup, monkeypatch):
    calls = []
    monkeypatch.setattr(ED, "main", lambda args: calls.append(args))
    assert GP.main(setup + ["--device", "cpu"]) == 2
    assert calls == []
    # the JAX tool's exit code for the same command line
    monkeypatch.setattr(sys, "argv", ["golden_parity.py"] + setup)
    with pytest.raises(SystemExit) as e:
        JGP.main()
    assert e.value.code == 2


def test_run_reference_without_reference_exits_2_before_evaluating(setup, monkeypatch):
    """--reference has no default: the reference checkout must be named."""
    calls = []
    monkeypatch.setattr(ED, "main", lambda args: calls.append(args))
    monkeypatch.setattr(GP, "run_reference", lambda args: calls.append(args))
    with pytest.raises(SystemExit) as e:
        GP.main(setup + ["--run_reference", "--device", "cpu"])
    assert e.value.code == 2
    assert calls == []


@pytest.mark.parametrize("case,code", [("jax_numbers", 0), ("a1_moved", 1),
                                       ("split_missing", 1)])
def test_main_exit_code_and_save(setup, jax_single, tmp_path, case, code):
    golden = _golden(jax_single, setup)
    tol = 0.001
    if case == "a1_moved":
        golden["eigen_benchmark"]["a1"] += 2 * tol
    elif case == "split_missing":
        golden["cityscapes"] = {"abs_rel": 0.1, "a1": 0.9}
    (tmp_path / "golden.json").write_text(json.dumps(golden))
    save = tmp_path / "out.json"
    argv = setup + ["--golden", str(tmp_path / "golden.json"), "--tolerance", str(tol),
                    "--save", str(save), "--device", "cpu"]
    assert GP.main(argv) == code
    out = json.loads(save.read_text())
    assert set(out) == {"ours", "golden", "tolerance", "pass"}
    assert out["pass"] is (code == 0) and out["tolerance"] == tol
    assert out["golden"] == golden and set(out["ours"]) == set(GP.SPLITS)


REFERENCE_STANDIN = r'''
import sys
print("-> Loading weights from", sys.argv[sys.argv.index("--pretrained_path") + 1])
print(" Evaluate on KITTI with eigen split:")
print(" Scaling ratios | med: 31.250 | std: 0.081")
print("\n  " + ("{:>8} | " * 7).format("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2",
                                       "a3"))
print(("&{: 8.3f}  " * 7).format(0.115, 0.903, 4.863, 0.193, 0.877, 0.959, 0.981) + "\\\\")
print(" Evaluate on KITTI with eigen_benchmark split:")
print(("{:>8} | " * 7).format("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3"))
print(("{: 8.3f} | " * 7).format(0.081, 0.412, 3.703, 0.123, 0.923, 0.986, 0.996))
sys.exit(int(sys.argv[sys.argv.index("--batch_size") + 1] == "13"))
'''


def test_run_reference_parses_as_the_jax_tool(tmp_path):
    (tmp_path / "evaluate_depth.py").write_text(REFERENCE_STANDIN)
    args = _args(["--kitti_path", "kitti", "--ckpt", "ckpt.pth", "--run_reference",
                  "--reference", str(tmp_path), "--post_process"])
    got = GP.run_reference(args)
    assert got == JGP.run_reference(argparse.Namespace(**vars(args)))
    assert got == {
        "eigen": dict(zip(GP.ALL_NAMES, (0.115, 0.903, 4.863, 0.193, 0.877, 0.959, 0.981))),
        "eigen_benchmark": dict(zip(GP.ALL_NAMES,
                                    (0.081, 0.412, 3.703, 0.123, 0.923, 0.986, 0.996))),
    }
    args.batch_size = 13  # the stand-in exits 1
    for tool in (GP, JGP):
        with pytest.raises(RuntimeError, match="rc=1"):
            tool.run_reference(args)
