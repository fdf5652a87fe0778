"""The port's config parser against the JAX package's (mono_vifi_tpu/config.py),
on every depth config the repo ships and a set of command-line overrides:
the same value, field by field, for every field of the JAX `Options` (the
port has one more, `device`). Also: the multi-card fields parse and are
refused only where they cannot run, and the entry module's command line
parses."""

import dataclasses
import pathlib

import pytest
import torch

from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.config import parse_options as jparse_options
from mono_vifi_tpu_torch.config import ENV_RENDEZVOUS, Options, check_port_options, parse_options

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(ROOT)) for d in ("resnet18", "litemono", "dhrnet")
                 for p in (ROOT / "configs" / d).glob("*.txt"))

OVERRIDES = [
    "--batch_size", "4", "--use_affine", "false", "--frame_ids", "0", "-1", "1",
    "--decay_step", "5", "10", "--learning_rate", "3e-4", "--fast_warp", "False",
    "--num_devices", "1", "--pretrained_path", "weights/x.pth", "--vfi_train_scale", "tiny",
    "--doj_mask", "yes", "--num_scales", "2", "--weights_init", "scratch", "--seed", "-1",
]


def test_all_nine_depth_configs_are_found():
    assert len(CONFIGS) == 9


@pytest.mark.parametrize("overrides", [False, True], ids=["file", "file+cli"])
@pytest.mark.parametrize("config", CONFIGS)
def test_parse_options_matches_jax(config, overrides, monkeypatch):
    monkeypatch.chdir(ROOT)
    argv = ["-c", config] + (OVERRIDES if overrides else [])
    ref, got = jparse_options(argv), parse_options(argv)
    for f in dataclasses.fields(JOptions):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
        assert type(getattr(got, f.name)) is type(getattr(ref, f.name)), f.name
    assert got.device == "cuda"


def test_options_defaults_match_jax():
    ref, got = JOptions(), Options()
    for f in dataclasses.fields(JOptions):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(Options)} - {
        f.name for f in dataclasses.fields(JOptions)} == {"device"}


def test_device_flag_parses(monkeypatch):
    monkeypatch.chdir(ROOT)
    cfg = parse_options(["-c", "configs/resnet18/ResNet18_KITTI_MR.txt", "--device", "cpu"])
    assert cfg.device == "cpu" and cfg.batch_size == 10 and cfg.use_affine


@pytest.mark.parametrize("field,value,match", [
    ("num_devices", 8, "1 CUDA cards visible"),  # more ranks than cards: refused
    ("distributed", True, "env rendezvous"),  # no torchrun env: refused
    ("encoder_remat", True, None),  # accepted
])
def test_tpu_fields_the_port_does_not_carry_are_refused(field, value, match, monkeypatch):
    """The multi-card and remat fields: what cannot run here is refused
    (more ranks than visible cards, `distributed` without the env
    rendezvous), `encoder_remat` is accepted."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k in ENV_RENDEZVOUS:
        monkeypatch.delenv(k, raising=False)
    check_port_options(Options(num_devices=1, fast_warp=False, profile_steps=2))
    if match is None:
        check_port_options(Options(**{field: value}))
    else:
        with pytest.raises(ValueError, match=match):
            check_port_options(Options(**{field: value}))


def test_multi_card_fields_are_accepted_where_they_can_run(monkeypatch):
    """Ranks on the CPU need no card; `distributed` runs with the env
    rendezvous; 0 cards' worth of ranks means every visible card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    check_port_options(Options(num_devices=4))
    check_port_options(Options(num_devices=0))
    check_port_options(Options(num_devices=8, device="cpu"))
    with pytest.raises(ValueError, match="num_devices=-1"):
        check_port_options(Options(num_devices=-1))
    for k, v in zip(ENV_RENDEZVOUS, ("0", "1", "0", "127.0.0.1", "29500")):
        monkeypatch.setenv(k, v)
    check_port_options(Options(distributed=True))
