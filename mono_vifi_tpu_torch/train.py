"""Mono-ViFI training driver (the port's counterpart of the root train.py;
reference train.py).

    python -m mono_vifi_tpu_torch.train -c configs/resnet18/ResNet18_KITTI_MR.txt \
        [--flag value ...] [--device cpu] [--num_devices N]
    torchrun --nproc_per_node N -m mono_vifi_tpu_torch.train -c ... --distributed true

Each process trains on one card (`--device`, CUDA unless another is named;
without a card CUDA raises instead of running on the CPU). `batch_size` is
the batch of one card. `--num_devices N` starts N such processes on this
host (0, the default: every visible card), `--distributed` makes this
process one rank of a `torchrun` job (mono_vifi_tpu_torch.parallel); the
global batch is then `batch_size` times the ranks, each rank reading its
own stride of the epoch's order. Per epoch: the stateful sampler's order
(resumed mid-epoch after a checkpoint), the threaded loader decoding and
augmenting on the host with uint8 staging, `device_prefetch` copying the
next batch while a step runs, the fused step, a log line every
`log_frequency` steps, a checkpoint every `save_frequency` steps; then
single- and multi-frame evaluation (KITTI, Cityscapes; NYUv2 single-frame)
and the epoch's weights. Rank 0 alone logs, writes and evaluates (on the
whole test split); the other ranks wait for it at a barrier after each
save and each evaluation.

cuDNN and TF32: a `Trainer` leaves `torch.backends.cudnn.benchmark` and
the TF32 switches as its caller set them. The command line entry sets
cudnn.benchmark, as the reference does, and leaves TF32 at PyTorch's
defaults (the bf16 configurations do not compute in f32).

The automask tie-break noise of each step, and LiteMono's stochastic-depth
masks, are drawn from a generator on the device seeded from (seed, step),
so that a resumed run draws what an uninterrupted one would (the JAX driver
folds the step into its key).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from mono_vifi_tpu_torch import evaluation, parallel
from mono_vifi_tpu_torch.config import Options, check_port_options, parse_options
from mono_vifi_tpu_torch.data import (
    CityscapesDataset, DataLoader, KITTIOdomDataset, KITTIRAWDataset, NYUDataset,
    StatefulDistributedSampler, device_prefetch,
)
from mono_vifi_tpu_torch.evaluate_depth import SPLITS_DIR
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.tracing import span
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import resolve_device
from mono_vifi_tpu_torch.training.monovifi import (
    MonoViFiStep, create_train_state, multi_frame_disp, prepare_batch, single_frame_disp,
)
from mono_vifi_tpu_torch.utils import readlines, sec_to_hm_str, setup_logging

DATASETS = {
    "kitti": KITTIRAWDataset,
    "kitti_odom": KITTIOdomDataset,
    "cityscapes": CityscapesDataset,
    "nyuv2": NYUDataset,
}


def dataset_class(name: str):
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name}")
    return DATASETS[name]


def split_paths(cfg: Options) -> tuple[str, str]:
    """{}-patterns of the train and test file lists (train.py:98-109)."""
    if cfg.dataset == "kitti":
        return (os.path.join(SPLITS_DIR, "kitti", cfg.split, "{}_files.txt"),
                os.path.join(SPLITS_DIR, "kitti", cfg.eval_split, "{}_files.txt"))
    if cfg.dataset == "kitti_odom":
        return (os.path.join(SPLITS_DIR, "kitti", "odom", "{}_files.txt"),
                os.path.join(SPLITS_DIR, "kitti", "odom", "{}_files_09.txt"))
    path = os.path.join(SPLITS_DIR, "nyuv2" if cfg.dataset == "nyuv2" else "cityscapes",
                        "{}_files.txt")
    return path, path


class Trainer:
    def __init__(self, cfg: Options):
        check_port_options(cfg)
        if cfg.height % 32 or cfg.width % 32:
            raise ValueError("height and width must be multiples of 32")
        dataset_cls = dataset_class(cfg.dataset)
        self.cfg = cfg
        self.rank, self.world = parallel.init_distributed(cfg)
        self.is_chief = self.rank == 0
        self.device = resolve_device(cfg.device)
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        self.log_path = os.path.join(cfg.log_dir, cfg.exp_name)
        if self.is_chief:
            os.makedirs(self.log_path, exist_ok=True)
        setup_logging(os.path.join(self.log_path, "logger.log"),
                      filemode="a" if cfg.resume else "w", rank=self.rank)
        if self.is_chief:
            self.save_opts()
        logging.info("Experiment: %s | device: %s | ranks: %d | backbone: %s", cfg.exp_name,
                     self.device, self.world, cfg.backbone)

        self.writer = None
        if self.is_chief:
            try:  # TensorBoard scalars (reference train.py:45-47, :1062-1067)
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(self.log_path, "tensorboard", "train"))
            except ImportError:
                pass

        # ---------------- data
        fpath, fpath_test = split_paths(cfg)
        train_files = readlines(fpath.format("train"))
        test_files = readlines(fpath_test.format("test"))
        img_ext = ".jpg" if cfg.jpg else ".png"
        data_path = cfg.data_path_pre if (
            cfg.dataset == "cityscapes" and cfg.data_path_pre) else cfg.data_path
        extra = {}
        if cfg.dataset == "cityscapes" and cfg.doj_mask:
            extra = {"doj_mask": True, "mask_dir": cfg.mask_dir or None}
        self.train_dataset = dataset_cls(
            data_path, train_files, cfg.height, cfg.width, cfg.frame_ids, cfg.num_scales,
            use_affine=cfg.use_affine, is_train=True, img_ext=img_ext, seed=cfg.seed,
            stage_uint8=True, **extra,
        )
        self.test_dataset = dataset_cls(
            cfg.data_path, test_files, cfg.height, cfg.width, [0, -1, 1], cfg.num_scales,
            is_train=False, img_ext=img_ext,
        )
        self.sampler = StatefulDistributedSampler(len(self.train_dataset), cfg.seed,
                                                  rank=self.rank, num_replicas=self.world)
        self.train_loader = DataLoader(self.train_dataset, cfg.batch_size, sampler=self.sampler,
                                       num_workers=cfg.num_workers, drop_last=True)
        self.test_loader = DataLoader(self.test_dataset, cfg.batch_size,
                                      num_workers=cfg.num_workers, drop_last=False)
        self.steps_per_epoch = len(self.sampler) // cfg.batch_size
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs
        self.gt_depths = self._load_gt_depths() if self.is_chief else None

        # ---------------- models and state
        self.state = create_train_state(cfg, max(cfg.seed, 0), self.steps_per_epoch,
                                        self.device)
        self.bundle = self.state.bundle
        self._load_frozen_vfi("vfi_train", cfg.vfi_train_scale)
        if self.bundle.vfi_test is not self.bundle.vfi_train:
            self._load_frozen_vfi("vfi_test", cfg.vfi_test_scale)

        self.ep_start, self.batch_start = 0, 0
        if cfg.pretrained_path and not (cfg.resume and os.path.exists(self.ckpt_path)):
            self.load_pretrained(cfg.pretrained_path)
        if cfg.resume:
            self.load_ckpt()
        if parallel.active():
            parallel.broadcast_module_(self.bundle)

        self.train_step = MonoViFiStep(self.bundle, self.device).make_train_step()
        self.noise = torch.Generator(device=self.device)
        self.history: list[dict] = []  # one entry per logged step
        self.eval_results: dict[tuple[int, str], dict] = {}
        logging.info("%d train / %d test items | %d steps/epoch", len(self.train_dataset),
                     len(self.test_dataset), self.steps_per_epoch)

    def close(self):
        """Flush and close the TensorBoard writer."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.log_path, "ckpt.pth")

    # ------------------------------------------------------------ aux setup
    def save_opts(self):
        """opt.json and a snapshot of the port's sources under codes/
        (reference train.py:1095-1106)."""
        with open(os.path.join(self.log_path, "opt.json"), "w") as f:
            json.dump({k: str(v) for k, v in vars(self.cfg).items()}, f, indent=2)
        src_root = Path(__file__).resolve().parent
        target = Path(self.log_path) / "codes"
        shutil.rmtree(target, ignore_errors=True)
        for src in src_root.rglob("*"):
            if src.suffix in (".py", ".cu", ".cuh") and not (
                    {"_build", "__pycache__"} & set(src.parts)):
                dst = target / src.relative_to(src_root.parent)
                dst.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy(src, dst)
        if self.cfg.config:
            shutil.copy(self.cfg.config, target / os.path.basename(self.cfg.config))

    def _load_gt_depths(self):
        cfg = self.cfg
        try:
            if cfg.dataset == "kitti":
                gt_path = os.path.join(SPLITS_DIR, "kitti", cfg.eval_split, "gt_depths.npz")
                return np.load(gt_path, fix_imports=True, encoding="latin1",
                               allow_pickle=True)["data"]
            if cfg.dataset == "cityscapes":
                gt_path = os.path.join(SPLITS_DIR, "cityscapes", "gt_depths")
                return [np.load(os.path.join(gt_path, str(i).zfill(3) + "_depth.npy"))
                        for i in range(len(self.test_dataset))]
        except OSError:
            logging.warning("gt depths not found; per-epoch eval disabled (run "
                            "python -m mono_vifi_tpu_torch.export_gt_depth to enable)")
        return None

    def _load_frozen_vfi(self, role: str, scale: str):
        """The frozen IFRNet of `role` from weights_dir/IFRNet_{L,S}_{KITTI,CS}
        as a reference `.pth` or a JAX weight-only `.pkl` (train.py:236-254);
        a missing file keeps the random init."""
        tag = "L" if scale == "large" else "S"
        ds = {"kitti": "KITTI", "cityscapes": "CS"}.get(self.cfg.dataset)
        stem = os.path.join(self.cfg.weights_dir, f"IFRNet_{tag}_{ds}")
        for path in (stem + ".pth", stem + ".pkl"):
            if ds and os.path.exists(path):
                logging.info("Loading frozen VFI (%s) from %s", role, path)
                ckpt_lib.load_vfi(path, self.bundle, role)
                return
        logging.warning("Frozen VFI weights missing (%s.pth): %s keeps random init; "
                        "train IFRNet first with python -m mono_vifi_tpu_torch.train_vfi",
                        stem, role)

    # ------------------------------------------------------------ ckpt mgmt
    def load_ckpt(self):
        if not os.path.exists(self.ckpt_path):
            logging.info("No checkpoint to resume; training from scratch")
            return
        logging.info("Resuming from %s", self.ckpt_path)
        self.ep_start, self.batch_start = ckpt_lib.load_checkpoint(self.ckpt_path, self.state)

    def load_pretrained(self, path: str) -> list[str]:
        """-> the keys that kept their init values (missing from the file
        or of another shape), each also named in a warning."""
        logging.info("Loading pretrained model from %s", path)
        if path.endswith(".pth"):
            return ckpt_lib.load_reference_pth(path, self.bundle)
        return ckpt_lib.load_jax_weights(path, self.bundle)

    def save_model(self, epoch: int, batch_idx: int = 0, ep_end: bool = False):
        """Rank 0 writes; every rank waits until it has."""
        if self.is_chief:
            if ep_end:
                ckpt_lib.save_weights(
                    os.path.join(self.log_path, "models", f"model_{epoch}.pth"),
                    self.bundle, self.cfg)
            ckpt_lib.save_checkpoint(self.ckpt_path, self.state, self.cfg,
                                     epoch=epoch + 1 if ep_end else epoch, batch_idx=batch_idx)
        parallel.barrier()

    # -------------------------------------------------------------- training
    def train(self):
        for epoch in range(self.ep_start, self.cfg.num_epochs):
            self.run_epoch(epoch)
            self.end_epoch(epoch)

    def end_epoch(self, epoch: int):
        """The per-epoch evaluation (rank 0, on the whole test split: the
        running statistics are equal on every rank), then the epoch's
        weights and checkpoint."""
        if self.is_chief:
            if self.cfg.dataset in ("kitti", "cityscapes") and self.gt_depths is not None:
                self.test(epoch, multi_frame=False)
                self.test(epoch, multi_frame=True)
            elif self.cfg.dataset == "nyuv2":
                self.test_nyuv2(epoch)
        parallel.barrier()
        self.save_model(epoch, ep_end=True)

    def noise_seed(self, step: int) -> int:
        return (max(self.cfg.seed, 0) + 17) * 1_000_003 + step

    def run_epoch(self, epoch: int):
        cfg = self.cfg
        logging.info("Training epoch %d", epoch)
        self.sampler.set_epoch(epoch)
        self.sampler.set_start_iter(self.batch_start * cfg.batch_size)
        self.train_dataset.set_epoch(epoch)

        # the trace covers steps 2 to profile_steps + 1: the first step's
        # cuDNN autotuning would swamp it
        profiling = cfg.profile_steps > 0 and epoch == self.ep_start and self.is_chief
        prof = None
        batches = enumerate(device_prefetch(self.train_loader, self.device))
        t_data = time.perf_counter()
        while True:
            with span("run_epoch.data_wait"):
                item = next(batches, None)
            if item is None:
                break
            batch_idx, batch = item
            with span("run_epoch.step"):
                self.noise.manual_seed(self.noise_seed(self.state.step))
                t_fp = time.perf_counter()
                metrics = self.train_step(self.state, batch, self.noise)
            if prof is not None and batch_idx >= cfg.profile_steps:
                prof = self._stop_profile(prof, metrics, batch_idx)

            global_idx = batch_idx + self.batch_start
            if global_idx % cfg.log_frequency == 0:
                with span("run_epoch.log"):
                    loss = float(metrics["loss"])  # waits for the step
                    t_now = time.perf_counter()
                    step_no = self.state.step
                    eta = (self.num_total_steps - step_no) * (t_now - t_data)
                    lr = self.state.schedule(step_no)
                    logging.info(
                        "epoch %2d/%d | batch %4d/%d | data %.3fs | step %.3fs | "
                        "loss %.4f | lr %.2e | eta %s",
                        epoch, cfg.num_epochs - 1, global_idx, self.steps_per_epoch,
                        t_fp - t_data, t_now - t_fp, loss, lr, sec_to_hm_str(eta),
                    )
                    self.history.append({"epoch": epoch, "batch": global_idx, "step": step_no,
                                         "data_s": t_fp - t_data, "step_s": t_now - t_fp,
                                         "t": t_now, "loss": loss, "lr": lr})
                    if self.writer is not None:
                        for k, v in metrics.items():
                            self.writer.add_scalar(k, float(v), step_no)
                        self.writer.add_scalar("learning_rate", lr, step_no)
            if global_idx > 0 and global_idx % cfg.save_frequency == 0:
                with span("run_epoch.checkpoint"):
                    self.save_model(epoch, batch_idx=global_idx + 1)
            if profiling and batch_idx == 0:
                prof = self._start_profile()
            t_data = time.perf_counter()
        if prof is not None:
            self._stop_profile(prof, metrics, batch_idx)
        self.batch_start = 0

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, metrics, batch_idx: int):
        float(metrics["loss"])
        prof.stop()
        trace_dir = os.path.join(self.log_path, "profile")
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        logging.info("Profiler trace of steps 2 to %d of the epoch in %s", batch_idx + 1,
                     trace_dir)
        return None

    # ------------------------------------------------------------------ eval
    def _predict_disps(self, multi_frame: bool) -> np.ndarray:
        """Scaled disparities (N, H, W) of the test split. Evaluation mode
        takes no batch statistics, so the last, shorter batch needs no
        padding."""
        disps = []
        for batch in self.test_loader:
            imgs = prepare_batch({k: batch[k] for k in ("color_n1", "color_0", "color_p1")},
                                 self.device)
            if multi_frame:
                d = multi_frame_disp(self.bundle, imgs["color_n1"], imgs["color_0"],
                                     imgs["color_p1"])
            else:
                d = single_frame_disp(self.bundle, imgs["color_0"])
            sd, _ = disp_to_depth(d, self.cfg.min_depth, self.cfg.max_depth)
            disps.append(sd[:, 0].cpu().numpy())
        return np.concatenate(disps, 0)

    def test(self, epoch: int, multi_frame: bool) -> dict:
        cfg = self.cfg
        tag = "multi-frame" if multi_frame else "single-frame"
        logging.info("Eval (%s) at epoch %d", tag, epoch)
        pred = self._predict_disps(multi_frame)
        stereo = cfg.use_stereo and not multi_frame
        if cfg.dataset == "kitti":
            res = evaluation.evaluate_kitti(pred, self.gt_depths, cfg.eval_split, stereo,
                                            printer=logging.info)
        else:
            res = evaluation.evaluate_cityscapes(pred, self.gt_depths, stereo,
                                                 printer=logging.info)
        self.eval_results[epoch, tag] = res
        if self.writer is not None:
            for k, v in res.items():
                self.writer.add_scalar(f"{tag}/{k}", v, epoch)
        return res

    def test_nyuv2(self, epoch: int) -> dict:
        """Per-epoch single-frame NYUv2 evaluation over the test split's
        `.h5` samples, one at a time (reference train.py:305-354)."""
        logging.info("NYUv2 eval at epoch %d", epoch)
        ds = self.test_dataset
        preds, gts = [], []
        for i in range(len(ds)):
            rgb, depth = ds.load_test_item(i)
            img = prepare_batch({"img": rgb[None]}, self.device)["img"]
            sd, _ = disp_to_depth(single_frame_disp(self.bundle, img), self.cfg.min_depth,
                                  self.cfg.max_depth)
            preds.append(sd[0, 0].cpu().numpy())
            gts.append(depth)
        res = evaluation.evaluate_nyuv2(np.stack(preds), gts, printer=logging.info)
        self.eval_results[epoch, "nyuv2"] = res
        return res


def run(cfg: Options):
    """Train one rank (or the only process) to the end."""
    if torch.device(cfg.device).type == "cuda":
        torch.backends.cudnn.benchmark = True
    trainer = Trainer(cfg)
    try:
        trainer.train()
    finally:
        trainer.close()


def main(argv=None):
    cfg = parse_options(argv)
    check_port_options(cfg)
    parallel.launch(run, cfg)


if __name__ == "__main__":
    main()
