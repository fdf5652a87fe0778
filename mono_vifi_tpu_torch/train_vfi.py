"""IFRNet VFI training driver (the port's counterpart of the root
train_vfi.py; reference train_vfi.py).

    python -m mono_vifi_tpu_torch.train_vfi -c configs/vfi/IFRNet_L_KITTI.txt \
        [--flag value ...] [--device cpu]

Trains IFRNet (`vfi_scale` small | large) on KITTI or Cityscapes triplets to
interpolate the middle frame, on one card (`--device`, CUDA unless another
is named; without a card CUDA raises). Per epoch: the stateful sampler's
order (resumed mid-epoch after a checkpoint), the threaded loader,
`device_prefetch`, the step; every `log_frequency` steps a log line and a
panel of the middle frame, the prediction and both flows
(`visuals/step_<n>.jpeg`, and TensorBoard when tensorboardX imports); a
checkpoint every `save_frequency` steps and at each epoch end. The
checkpoint, `ckpt.pth`, holds IFRNet's state_dict under the reference's
`VFI` key, so a depth run takes it as its frozen VFI once it is copied to
`weights_dir/IFRNet_{L,S}_{KITTI,CS}.pth`.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from mono_vifi_tpu_torch.config import Options, check_port_options, parse_options
from mono_vifi_tpu_torch.data import (
    CityscapesVFIDataset, DataLoader, KITTIVFIDataset, StatefulSampler, device_prefetch,
)
from mono_vifi_tpu_torch.evaluate_depth import SPLITS_DIR
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import resolve_device
from mono_vifi_tpu_torch.training.vfi import create_vfi_state, make_vfi_train_step
from mono_vifi_tpu_torch.utils import readlines, sec_to_hm_str, setup_logging
from mono_vifi_tpu_torch.utils.flow_vis import flow_to_color


class VFITrainer:
    def __init__(self, cfg: Options):
        check_port_options(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.log_path = os.path.join(cfg.log_dir, cfg.exp_name)
        os.makedirs(self.log_path, exist_ok=True)
        setup_logging(os.path.join(self.log_path, "logger.log"),
                      filemode="a" if cfg.resume else "w")

        if cfg.dataset == "kitti":
            files = readlines(os.path.join(SPLITS_DIR, "kitti", cfg.split, "train_files.txt"))
            self.dataset = KITTIVFIDataset(
                cfg.data_path, files, cfg.height, cfg.width, is_train=True,
                img_ext=".jpg" if cfg.jpg else ".png", seed=cfg.seed)
        elif cfg.dataset == "cityscapes":
            files = readlines(os.path.join(SPLITS_DIR, "cityscapes", "train_files.txt"))
            self.dataset = CityscapesVFIDataset(
                cfg.data_path_pre or cfg.data_path, files, cfg.height, cfg.width,
                is_train=True, seed=cfg.seed)
        else:
            raise ValueError(f"VFI training on {cfg.dataset}: kitti or cityscapes")
        self.sampler = StatefulSampler(len(self.dataset), cfg.seed)
        self.loader = DataLoader(self.dataset, cfg.batch_size, sampler=self.sampler,
                                 num_workers=cfg.num_workers)
        self.steps_per_epoch = len(self.sampler) // cfg.batch_size
        self.num_total_steps = self.steps_per_epoch * cfg.num_epochs

        self.state = create_vfi_state(cfg, max(cfg.seed, 0), self.steps_per_epoch,
                                      self.device)
        self.ep_start, self.batch_start = 0, 0
        if cfg.pretrained_path and os.path.exists(cfg.pretrained_path):
            self.load_pretrained(cfg.pretrained_path)
        if cfg.resume:
            self.load_ckpt()
        self.train_step = make_vfi_train_step(cfg.clip_grad)
        self.history: list[dict] = []  # one entry per logged step

        self.writer = None
        try:  # scalars and image/flow panels (reference train_vfi.py:251-268)
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(os.path.join(self.log_path, "tensorboard", "train"))
        except ImportError:
            pass
        logging.info("VFI training: %s (%s) | device %s | %d items | %d steps/epoch",
                     cfg.dataset, cfg.vfi_scale, self.device, len(self.dataset),
                     self.steps_per_epoch)

    def close(self):
        """Flush and close the TensorBoard writer."""
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.log_path, "ckpt.pth")

    def load_pretrained(self, path: str):
        """IFRNet's weights from a reference `.pth` (its `VFI` entry or a bare
        state_dict) or a JAX `.pkl` (tolerant: see checkpoint.load_roles)."""
        logging.info("Loading pretrained VFI from %s", path)
        ckpt_lib.load_roles(self.state, {"module": ckpt_lib.read_vfi(path)})

    def load_ckpt(self):
        if not os.path.exists(self.ckpt_path):
            logging.info("No VFI checkpoint to resume")
            return
        self.ep_start, self.batch_start = ckpt_lib.load_vfi_checkpoint(self.ckpt_path,
                                                                       self.state)
        logging.info("Resumed at epoch %d batch %d", self.ep_start, self.batch_start)

    def save_model(self, epoch: int, batch_idx: int = 0, ep_end: bool = False):
        ckpt_lib.save_vfi_checkpoint(self.ckpt_path, self.state, self.cfg,
                                     epoch=epoch + 1 if ep_end else epoch, batch_idx=batch_idx)

    def _log_visuals(self, batch, aux, step: int):
        """gt | prediction over flow0 | flow1 of the batch's first item."""
        from PIL import Image

        vis_dir = os.path.join(self.log_path, "visuals")
        os.makedirs(vis_dir, exist_ok=True)

        def hwc(t):
            return t[0].float().permute(1, 2, 0).cpu().numpy()

        pred = hwc(aux["imgt_pred"])
        gt = batch["img1"][0].cpu().numpy()
        fl0 = flow_to_color(hwc(aux["flow0"]))
        fl1 = flow_to_color(hwc(aux["flow1"]))
        top = np.concatenate([gt, pred], 1)
        bottom = np.concatenate([fl0 / 255.0, fl1 / 255.0], 1)
        panel = (np.concatenate([top, bottom], 0) * 255).astype(np.uint8)
        Image.fromarray(panel).save(os.path.join(vis_dir, f"step_{step}.jpeg"))
        if self.writer is not None:
            self.writer.add_image("img1_gt", gt, step, dataformats="HWC")
            self.writer.add_image("img1_pred", pred, step, dataformats="HWC")
            self.writer.add_image("flow0", fl0, step, dataformats="HWC")
            self.writer.add_image("flow1", fl1, step, dataformats="HWC")

    def train(self):
        for epoch in range(self.ep_start, self.cfg.num_epochs):
            self.run_epoch(epoch)
            self.save_model(epoch, ep_end=True)

    def run_epoch(self, epoch: int):
        cfg = self.cfg
        self.sampler.set_epoch(epoch)
        self.sampler.set_start_iter(self.batch_start * cfg.batch_size)
        self.dataset.set_epoch(epoch)
        t0 = time.perf_counter()
        for batch_idx, batch in enumerate(device_prefetch(self.loader, self.device)):
            metrics, aux = self.train_step(self.state, batch)
            gidx = batch_idx + self.batch_start
            if gidx % cfg.log_frequency == 0:
                loss, psnr = float(metrics["loss"]), float(metrics["psnr"])  # waits
                dt = time.perf_counter() - t0
                step = self.state.step
                logging.info(
                    "epoch %3d/%d | batch %4d/%d | step %.3fs | loss %.4f | psnr %.2f | eta %s",
                    epoch, cfg.num_epochs - 1, gidx, self.steps_per_epoch, dt, loss, psnr,
                    sec_to_hm_str((self.num_total_steps - step) * dt))
                self.history.append({"epoch": epoch, "batch": gidx, "step": step,
                                     "step_s": dt, "loss": loss, "psnr": psnr,
                                     "grad_norm": float(metrics["grad_norm"])})
                if self.writer is not None:
                    self.writer.add_scalar("loss", loss, step)
                    self.writer.add_scalar("psnr", psnr, step)
                self._log_visuals(batch, aux, step)
            if gidx > 0 and gidx % cfg.save_frequency == 0:
                self.save_model(epoch, batch_idx=gidx + 1)
            t0 = time.perf_counter()
        self.batch_start = 0


def main(argv=None):
    cfg = parse_options(argv)
    if torch.device(cfg.device).type == "cuda":
        torch.backends.cudnn.benchmark = True
    trainer = VFITrainer(cfg)
    try:
        trainer.train()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
