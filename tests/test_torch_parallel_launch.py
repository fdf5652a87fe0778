"""Starting the port's ranks as the command line does: `python -m
mono_vifi_tpu_torch.train --distributed true` in two processes that
`torchrun` would start (the env rendezvous, gloo on the CPU; the rank
processes are those of tests/test_torch_parallel.py), `--num_devices`
through `main` and `parallel.launch`, `parallel.spawn_local`'s file
rendezvous, and a trainer that is asked for more ranks than it is."""

from __future__ import annotations

import pytest
import torch

from mono_vifi_tpu_torch import parallel
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch import train_vfi as TVT
from mono_vifi_tpu_torch.config import Options

from tests.test_torch_parallel import run_ranks
from tests.test_torch_parallel_train import kitti_tree, trainer_argv  # noqa: F401 (fixture)


def _torchrun_case(job, rank, world):
    """`python -m mono_vifi_tpu_torch.train ... --distributed true` in a
    rank that `torchrun` started: the env rendezvous, gloo on the CPU."""
    T.SPLITS_DIR = job["splits"]
    T.main(job["argv"] + ["--distributed", "true", "--save_frequency", "100"])
    return {"left_a_group": parallel.active()}


def test_distributed_main_trains_from_the_env_rendezvous(kitti_tree, tmp_path):
    data_path, splits = kitti_tree
    job = {"argv": trainer_argv(data_path, str(tmp_path / "logs")), "splits": splits}
    outs = run_ranks("torchrun", job, tmp_path, torchrun=True)
    assert not any(o["left_a_group"] for o in outs)
    run = tmp_path / "logs" / "run"
    ckpt = torch.load(run / "ckpt.pth", weights_only=True)
    assert (ckpt["epoch"], ckpt["step_in_total"]) == (1, 3)
    assert (run / "models" / "model_0.pth").exists()


# ------------------------------------------------------- starting the ranks

def test_main_starts_the_ranks_the_options_ask_for(monkeypatch):
    """`--num_devices 2` spawns two ranks of the trainer's `run`; one rank
    (0 or 1 on the CPU) runs in this process."""
    spawned = []
    monkeypatch.setattr(parallel, "spawn_local",
                        lambda fn, world, *args, **kw: spawned.append((fn, world, args, kw)))
    T.main(["--num_devices", "2", "--device", "cpu"])
    TVT.main(["--num_devices", "2", "--device", "cpu"])
    assert [(fn, world, kw) for fn, world, _, kw in spawned] == [
        (T.run, 2, {"device": "cpu"}), (TVT.run, 2, {"device": "cpu"})]
    assert all(args[0].num_devices == 2 for _, _, args, _ in spawned)
    here = []
    for module in (T, TVT):
        monkeypatch.setattr(module, "run", lambda cfg: here.append(cfg.num_devices))
        for n in ("1", "0"):
            module.main(["--num_devices", n, "--device", "cpu"])
    assert here == [1, 0, 1, 0] and len(spawned) == 2


def test_spawn_local_joins_the_ranks(tmp_path):
    """Two spawned ranks meet at a barrier through the file rendezvous."""
    parallel.spawn_local(parallel.barrier, 2, device="cpu")
    assert not parallel.active()


def test_a_trainer_alone_refuses_more_ranks_than_it_is():
    cfg = Options(num_devices=2, device="cpu")
    with pytest.raises(RuntimeError, match="start the ranks with `launch`"):
        parallel.init_distributed(cfg)


CASES = {"torchrun": _torchrun_case}
ENV_CASES = {"torchrun"}
