"""The fused Mono-ViFI training step (counterpart of
mono_vifi_tpu/training/monovifi.py, reference train.py:698-941).

One step batches the reference's ~17 sequential module forwards into a few
large calls, in the JAX package's order: two synthesis pairs and one
only-flow pair through the frozen IFRNet; PoseNet over 6 pairs; one rotate +
crop of both synthesized frames; one encoder pass over 8B images; the
single-frame decoder; the FusionModule over 3 triplets through the
unique-table warp, then the multi-frame decoder; photometric losses over
6B + 3B stacked targets with automasking; the SVDC and SADC SI-log
consistency losses. BatchNorm statistics are taken over each fused batched
call, as in the JAX package.

In a process group (mono_vifi_tpu_torch.parallel) each rank takes its own
rows of the global batch: BatchNorm normalizes over the global batch, the
step's random draws are the global ones with the rank's rows kept, and the
gradients and logged metrics are averaged over the ranks, so the step is
the JAX package's step on a batch-sharded mesh. Every loss is a mean of
per-sample terms, so the mean of the ranks' equal-sized local losses is the
global loss.

Images travel channel-planar (B, C, H, W). The batch arrives in the JAX
package's format (NHWC images, uint8 or f32) and is converted once.

The eval forwards `single_frame_disp` and `multi_frame_disp` (reference
evaluate_depth.py / evaluate_depth_mf.py) close the file.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from mono_vifi_tpu_torch import parallel
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models.common import recomputing
from mono_vifi_tpu_torch.ops import geometry
from mono_vifi_tpu_torch.ops import image as image_ops
from mono_vifi_tpu_torch.ops import losses as L
from mono_vifi_tpu_torch.ops.cuda.photometric import ssim_l1_map, ssim_l1_map_nograd
from mono_vifi_tpu_torch.ops.sampling import sample_planar
from mono_vifi_tpu_torch.tracing import span
from mono_vifi_tpu_torch.training import graphs
from mono_vifi_tpu_torch.training.factory import ModelBundle, build_bundle, resolve_device
from mono_vifi_tpu_torch.training.optim import (
    clip_by_global_norm_, global_norm, lr_schedule, make_optimizer, set_lr,
)
from mono_vifi_tpu_torch.training.pretrained import apply_pretrained

# stacked-target bookkeeping of the JAX package (monovifi.py:421-487)
IDENT_REUSE = (0, 1, 2, 0, 2, 1)  # identity maps of targets (0, pt, nt, 0, nt, pt)
TABLE_USES = (1, 1, 0, 2, 0, 2)  # prev: fn1, fn1, f0; next: fp1, f0, fp1


def _tile(x, n):
    return torch.cat([x] * n, 0)


def dequantize_batch(batch):
    """uint8 planes -> f32 / 255 on the device; other entries pass through."""
    return {
        k: (v.float() / 255.0 if v.dtype == torch.uint8 else v)
        for k, v in batch.items()
    }


def prepare_batch(batch, device):
    """JAX-format batch (numpy or torch, NHWC images) -> tensors on `device`,
    dequantized, with every 4-D entry channel-planar (B, C, H, W)."""
    out = {}
    for k, v in batch.items():
        out[k] = torch.as_tensor(v).to(device, non_blocking=True)
    out = dequantize_batch(out)
    return {k: (L.to_planar(v) if v.dim() == 4 else v) for k, v in out.items()}


class MonoViFiStep:
    """The loss and the train step for one ModelBundle. `device` must match
    the bundle's; like every entry point it defaults to CUDA and raises
    without a card. In a process group, the batch handed to the step is the
    rank's rows `rank * B:(rank + 1) * B` of the global batch."""

    def __init__(self, bundle: ModelBundle, device=None):
        self.b = bundle
        self.cfg = bundle.cfg
        self.device = resolve_device(device)
        self.rank, self.world = parallel.rank_and_world()
        dev = next(bundle.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"bundle is on {dev}, step asked for {self.device}")

    def noise_shapes(self, B: int, H: int, W: int) -> dict:
        """Shapes of the automask tie-break noise draws of one step."""
        n = 1 if self.cfg.avg_reprojection else 2
        shapes = {"n1": (n, 6 * B, H, W)}
        if self.cfg.use_affine:
            shapes["n2"] = (n, 3 * B, H, W)
        return shapes

    def encoder_batches(self, B: int) -> dict:
        """{encoder role: images in its one training pass}."""
        n_sf = 6 if self.cfg.use_affine else 3
        if self.cfg.fuse_model_type == "separate_all":
            return {"encoder": n_sf * B, "encoder_mf": 5 * B}
        return {"encoder": (n_sf + 2) * B}

    def draw_drop_masks(self, B: int, generator=None) -> dict:
        """The stochastic-depth keep masks of one training step,
        {"drop_path_<role>": (blocks, images) bool}, drawn from `generator`
        for each encoder that has stochastic depth (LiteMono)."""
        out = {}
        for role, n in self.encoder_batches(B).items():
            enc = getattr(self.b, role)
            if getattr(enc, "num_drop_paths", 0):
                out[f"drop_path_{role}"] = enc.draw_drop_masks(n, generator, self.device)
        return out

    def draw_noise(self, B: int, H: int, W: int, generator=None, train: bool = True) -> dict:
        """The step's random draws for a local batch of B: the automask
        noise, then (train) the drop masks, drawn at the global batch's
        shapes, as the JAX step draws them once for the global batch, and
        cut to this rank's rows (`local_noise`)."""
        Bg = self.world * B
        noise = {k: torch.randn(s, generator=generator, device=self.device)
                 for k, s in self.noise_shapes(Bg, H, W).items()}
        if train:
            noise.update(self.draw_drop_masks(Bg, generator))
        return self.local_noise(noise, B)

    def local_noise(self, noise: dict, B: int) -> dict:
        """This rank's rows of the global draws. Their rows are stacked by
        role or target, each a block of the global batch (the automask
        noise (n, k * Bg, H, W), the drop masks (blocks, k * Bg)), so the
        rank keeps rows rank * B:(rank + 1) * B of every block."""
        if self.world == 1:
            return noise
        Bg, lo, hi = self.world * B, self.rank * B, (self.rank + 1) * B
        out = {}
        for k, v in noise.items():
            blocks = v.view(v.shape[0], -1, Bg, *v.shape[2:])[:, :, lo:hi]
            out[k] = blocks.reshape(v.shape[0], -1, *v.shape[2:])
        return out

    # ------------------------------------------------------------- helpers
    def _encode(self, role, x, noise):
        """The encoder's training pass. With `encoder_remat` its activations
        are recomputed in the backward pass instead of kept (the JAX step's
        jax.checkpoint): the recompute takes the same drop masks and leaves
        the BatchNorm statistics alone (`recomputing`). In a process group
        the recompute repeats the global BatchNorm's forward all-reduces;
        every rank recomputes the same encoder at the same point of the
        same backward graph, so the collectives pair up in the same order."""
        masks = noise.get(f"drop_path_{role}")
        enc = getattr(self.b, role)

        def run(x, masks):
            return enc(x) if masks is None else enc(x, masks)

        if not self.cfg.encoder_remat:
            return run(x, masks)
        return checkpoint(run, x, masks, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(), recomputing()))

    def _photometric(self, disp, tgt, src_n1, src_p1, T_n1, T_p1, K, invK,
                     noise, mask_rec=None, smooth_dyn_mask=None,
                     ident_reuse=None):
        """Batched compute_losses_base (reference train.py:987-1051) over a
        stack of N targets; disp (N, 1, H, W), images (N, 3, H, W). Returns
        the scalar mean over the stack."""
        cfg = self.cfg
        disp = disp.float()
        _, depth = geometry.disp_to_depth(disp, cfg.min_depth, cfg.max_depth)
        gx_n1, gy_n1 = geometry.reprojection_grid_planar(depth[:, 0], K, invK, T_n1)
        gx_p1, gy_p1 = geometry.reprojection_grid_planar(depth[:, 0], K, invK, T_p1)
        N = src_n1.shape[0]
        # both source frames in one kernel launch, bf16 taps in the bf16 path
        td = self.b.dtype if self.b.dtype != torch.float32 else None
        pred2 = sample_planar(
            torch.cat([src_n1, src_p1], 0), torch.cat([gx_n1, gx_p1], 0),
            torch.cat([gy_n1, gy_p1], 0), "border", tap_dtype=td,
        ).float()
        use_ssim = not cfg.no_ssim
        reproj = torch.stack(
            [ssim_l1_map(pred2[:N], tgt, use_ssim),
             ssim_l1_map(pred2[N:], tgt, use_ssim)], 0
        )
        if cfg.avg_reprojection:
            reproj = reproj.mean(0, keepdim=True)

        if not cfg.disable_automasking:
            if ident_reuse is not None:
                # targets repeat: identity maps of equal (src, tgt) blocks
                # are computed once and re-indexed
                Bs = N // len(ident_reuse)
                u = (max(ident_reuse) + 1) * Bs
                ident_u = torch.stack(
                    [ssim_l1_map_nograd(src_n1[:u], tgt[:u], use_ssim),
                     ssim_l1_map_nograd(src_p1[:u], tgt[:u], use_ssim)], 0
                )
                ident = torch.cat(
                    [ident_u[:, i * Bs:(i + 1) * Bs] for i in ident_reuse], 1
                )
            else:
                ident = torch.stack(
                    [ssim_l1_map_nograd(src_n1, tgt, use_ssim),
                     ssim_l1_map_nograd(src_p1, tgt, use_ssim)], 0
                )
            if cfg.avg_reprojection:
                ident = ident.mean(0, keepdim=True)
            ident = ident + noise * 1e-5
            combined = torch.cat([ident, reproj], 0)
        else:
            combined = reproj

        to_opt = combined.min(0).values if combined.shape[0] > 1 else combined[0]
        if mask_rec is not None:
            to_opt = to_opt * mask_rec[:, 0]
        loss = to_opt.mean()

        norm_disp = disp / (disp.mean(dim=(2, 3), keepdim=True) + 1e-7)
        if smooth_dyn_mask is not None:
            smooth = L.smooth_loss_dyn_planar(norm_disp[:, 0], tgt, smooth_dyn_mask)
        else:
            smooth = L.smooth_loss_planar(norm_disp[:, 0], tgt)
        return loss + cfg.disparity_smoothness * smooth

    # ------------------------------------------------------------ the loss
    def loss_fn(self, batch, generator=None, noise=None, train=True):
        """-> (loss, metrics). `noise` optionally supplies the step's random
        draws for this batch: the automask tie-break noise ({"n1", "n2"},
        shapes from `noise_shapes`) and, in train mode, the encoders'
        stochastic-depth masks (`draw_drop_masks`); otherwise they are drawn
        from `generator` (an explicit torch.Generator on the step's device,
        seeded alike on every rank) by `draw_noise`. In train mode BatchNorm
        running statistics update in place."""
        cfg, b = self.cfg, self.b
        batch = prepare_batch(batch, self.device)
        B, _, H, W = batch["color_0"].shape
        if noise is None:
            noise = self.draw_noise(B, H, W, generator, train)
        b.train(train)
        img_n1, img_0, img_p1 = batch["color_n1"], batch["color_0"], batch["color_p1"]
        aug_n1, aug_0, aug_p1 = (
            batch["color_aug_n1"], batch["color_aug_0"], batch["color_aug_p1"]
        )
        K, invK = batch["K"], batch["inv_K"]

        # ---- frozen VFI-L: two synthesis pairs, plus the (n1, p1) pair's flows
        with span("forward.vfi"):
            with torch.no_grad():
                embt2 = torch.full((2 * B, 1, 1, 1), 0.5, device=self.device)
                vfi_out = b.vfi_train(
                    torch.cat([img_n1, img_0], 0), torch.cat([img_0, img_p1], 0), embt2
                )
                flows_01 = b.vfi_train(img_n1, img_p1, embt2[:B], only_flow=True)
            pred = vfi_out["imgt_pred"].float()
            fl0, fl1 = vfi_out["flow0"].float(), vfi_out["flow1"].float()
            msk = vfi_out["mask"].float()
            img_nt, img_pt = pred[:B], pred[B:]
            flow_nt_n1, flow_nt_0 = fl0[:B], fl1[:B]
            flow_pt_0, flow_pt_p1 = fl0[B:], fl1[B:]
            flow_0_n1, flow_0_p1 = flows_01["flow0"].float(), flows_01["flow1"].float()
            mask_nt, mask_pt, mask_01 = msk[:B], msk[B:], flows_01["mask"].float()

        # ---- 6 pose pairs in one pass (reference train.py:728-733, :943-954)
        with span("forward.pose"):
            pose_pairs = [
                (aug_n1, aug_0), (aug_0, aug_p1),
                (img_n1, img_nt), (img_nt, img_p1),
                (img_n1, img_pt), (img_pt, img_p1),
            ]
            pose_in = torch.cat([torch.cat([a, c], 1) for a, c in pose_pairs], 0)
            pfeats = b.pose_encoder(pose_in)
            aa, tr = b.pose(pfeats[-1].float())
            aa0, tr0 = aa[:, 0, 0], tr[:, 0, 0]
            fwd = geometry.transformation_from_parameters(aa0, tr0, False)
            inv = geometry.transformation_from_parameters(aa0, tr0, True)
            T_0_n1, T_0_p1 = inv[:B], fwd[B:2 * B]
            T_nt_n1, T_nt_p1 = inv[2 * B:3 * B], fwd[3 * B:4 * B]
            T_pt_n1, T_pt_p1 = inv[4 * B:5 * B], fwd[5 * B:6 * B]

        # ---- both synthesized frames rotate + crop in one batched call
        if cfg.use_affine:
            with span("forward.rotate_crop"):
                angle, box = batch["angle"], batch["box"]
                rot2 = image_ops.rotate_bilinear(
                    torch.cat([img_nt, img_pt], 0), _tile(angle, 2)
                )
                aff2 = image_ops.batched_crop_resize(rot2, _tile(box, 2))
                img_nt_aff, img_pt_aff = aff2[:B], aff2[B:]

        # ---- depth encoder: one fused pass
        with span("forward.encoder"):
            sf_inputs = [aug_0, img_nt, img_pt]
            if cfg.use_affine:
                sf_inputs += [batch["color_affine_aug_0"], img_nt_aff, img_pt_aff]
            n_sf = len(sf_inputs)
            if cfg.fuse_model_type == "separate_all":
                feats_sf = self._encode("encoder", torch.cat(sf_inputs, 0), noise)
                mf_stack = self._encode(
                    "encoder_mf", torch.cat([aug_0, img_nt, img_pt, aug_n1, aug_p1], 0), noise)
                fn1_mf = [f[3 * B:4 * B] for f in mf_stack]
                fp1_mf = [f[4 * B:] for f in mf_stack]
            else:
                mf_stack = self._encode(
                    "encoder", torch.cat(sf_inputs + [aug_n1, aug_p1], 0), noise)
                feats_sf = [f[:n_sf * B] for f in mf_stack]
                fn1_mf = [f[n_sf * B:(n_sf + 1) * B] for f in mf_stack]
                fp1_mf = [f[(n_sf + 1) * B:] for f in mf_stack]
            f0_mf = [f[:B] for f in mf_stack]

        # ---- single-frame disparities (one decoder pass)
        with span("forward.depth"):
            disp_sf = b.depth(feats_sf)[0].float()
            disp_0, disp_nt, disp_pt = disp_sf[:B], disp_sf[B:2 * B], disp_sf[2 * B:3 * B]
            if cfg.use_affine:
                disp_0_aff = disp_sf[3 * B:4 * B]
                disp_nt_aff = disp_sf[4 * B:5 * B]
                disp_pt_aff = disp_sf[5 * B:6 * B]

        def to_depth(d):
            return geometry.disp_to_depth(d, cfg.min_depth, cfg.max_depth)[1]

        # ---- multi-frame: 3 fusion triplets in one pass; their prev/next
        # pyramids are 3 unique pyramids (f0, fn1, fp1) read through a table
        with span("forward.fusion"):
            center = [f[:3 * B] for f in mf_stack]
            flow_prev = torch.cat([flow_0_n1, flow_nt_n1, flow_pt_0], 0)
            flow_next = torch.cat([flow_0_p1, flow_nt_0, flow_pt_p1], 0)
            mask3 = torch.cat([mask_01, mask_nt, mask_pt], 0)
            unique = [torch.cat([a, a2, a3], 0) for a, a2, a3 in zip(f0_mf, fn1_mf, fp1_mf)]
            ids = image_ops.device_constant(
                tuple(p * B + j for p in TABLE_USES for j in range(B)), torch.int32,
                self.device)
            fused = b.fusion_module(center, (flow_prev, flow_next), mask3, (unique, ids))
            disp_fuse = b.role("depth_mf")(fused)[0].float()
            disp_0_fuse = disp_fuse[:B]
            disp_nt_fuse = disp_fuse[B:2 * B]
            disp_pt_fuse = disp_fuse[2 * B:]

        # ---- photometric losses over 6 stacked targets (train.py:746-812)
        with span("forward.photometric"):
            disp_stack = torch.cat(
                [disp_0, disp_pt, disp_nt, disp_0_fuse, disp_nt_fuse, disp_pt_fuse], 0
            )
            tgt_stack = torch.cat([img_0, img_pt, img_nt, img_0, img_nt, img_pt], 0)
            Tn1_stack = torch.cat([T_0_n1, T_pt_n1, T_nt_n1, T_0_n1, T_nt_n1, T_pt_n1], 0)
            Tp1_stack = torch.cat([T_0_p1, T_pt_p1, T_nt_p1, T_0_p1, T_nt_p1, T_pt_p1], 0)
            sdm6 = None
            use_dyn = cfg.use_smooth_dyn and "doj_mask_0" in batch
            if use_dyn:
                d0 = batch["doj_mask_0"][:, 0]
                z = torch.zeros_like(d0)
                sdm6 = torch.cat([d0, z, z, d0, z, z], 0)
            loss_base = 6.0 * self._photometric(
                disp_stack, tgt_stack, _tile(img_n1, 6), _tile(img_p1, 6),
                Tn1_stack, Tp1_stack, _tile(K, 6), _tile(invK, 6), noise.get("n1"),
                smooth_dyn_mask=sdm6, ident_reuse=IDENT_REUSE,
            )

        # ---- SVDC: single <-> fused SI-log consistency (train.py:797-812)
        with span("forward.svdc"):
            depth_single3 = to_depth(torch.cat([disp_0, disp_nt, disp_pt], 0))
            depth_fuse3 = to_depth(torch.cat([disp_0_fuse, disp_nt_fuse, disp_pt_fuse], 0))
            loss_dc = 3.0 * L.si_log_depth_loss(depth_single3, depth_fuse3)

        # ---- affine branch (train.py:814-922)
        if cfg.use_affine:
            with span("forward.affine_losses"):
                T6 = torch.cat([T_0_n1, T_pt_n1, T_nt_n1, T_0_p1, T_pt_p1, T_nt_p1], 0)
                T6_aff = geometry.conjugate_pose(T6, _tile(batch["Rc"], 6))
                disp_aff_stack = torch.cat([disp_0_aff, disp_pt_aff, disp_nt_aff], 0)
                tgt_aff_stack = torch.cat(
                    [batch["color_affine_0"], img_pt_aff, img_nt_aff], 0
                )
                sdm3 = None
                if use_dyn and "doj_mask_0_affine" in batch:
                    da = batch["doj_mask_0_affine"][:, 0]
                    za = torch.zeros_like(da)
                    sdm3 = torch.cat([da, za, za], 0)
                loss_base = loss_base + 3.0 * self._photometric(
                    disp_aff_stack, tgt_aff_stack,
                    _tile(batch["color_affine_n1"], 3), _tile(batch["color_affine_p1"], 3),
                    T6_aff[:3 * B], T6_aff[3 * B:], _tile(K, 3), _tile(invK, 3),
                    noise.get("n2"), mask_rec=_tile(batch["valid_mask_rec"], 3),
                    smooth_dyn_mask=sdm3,
                )

                # SADC: restore the affine depths and compare (train.py:904-922);
                # the rotate's image gradient comes from the splat kernel
                placed = image_ops.batched_place_resize(
                    to_depth(disp_aff_stack), _tile(box, 3)
                )
                restored = image_ops.rotate_bilinear(
                    placed, -_tile(angle, 3), grad_via_splat=True
                )
                ratio = batch["ratio_local"].reshape(B, 1, 1, 1)
                restored = restored * _tile(ratio, 3)
                depth_single3o = to_depth(torch.cat([disp_0, disp_pt, disp_nt], 0))
                depth_fuse3o = to_depth(torch.cat([disp_0_fuse, disp_pt_fuse, disp_nt_fuse], 0))
                mc3 = _tile(batch["valid_mask_cons"], 3)
                loss_sadc = 3.0 * (
                    L.si_log_depth_loss(restored, depth_fuse3o, mc3)
                    + L.si_log_depth_loss(restored, depth_single3o, mc3)
                )
                loss_dc = loss_dc + loss_sadc
        else:
            loss_sadc = torch.zeros((), device=self.device)

        loss = loss_base + cfg.lamda * loss_dc
        metrics = {
            "loss": loss, "loss_base": loss_base, "loss_dc": loss_dc,
            "loss_sadc": loss_sadc,
        }
        return loss, metrics

    # ---------------------------------------------------------- train step
    def make_train_step(self):
        """-> train_step(state, batch, generator=None, noise=None) -> metrics.
        Updates the state's parameters, optimizer moments and BatchNorm
        statistics in place: backward, global-norm clip, then the update at
        the schedule's rate for `state.step`. The random draws not given
        in `noise` come from `generator` first (`draw_noise`). On the card
        the step replays CUDA graphs once its input signature repeats
        (`run_train_step`), except with `encoder_remat`, whose recompute
        PyTorch's checkpoint makes on the host at backward time. In a
        process group the metrics are the global batch's (averaged over
        the ranks)."""
        def train_step(state, batch, generator=None, noise=None):
            if noise is None:
                B, H, W = batch["color_0"].shape[:3]
                noise = self.draw_noise(B, H, W, generator)
            drawn = {f"noise.{k}": v for k, v in noise.items()}

            def forward(x):
                loss, metrics = self.loss_fn(
                    {k: v for k, v in x.items() if k not in drawn},
                    noise={k[6:]: x[k] for k in drawn}, train=True)
                return loss, {k: v.detach() for k, v in metrics.items()}

            return run_train_step(state, "monovifi", (self.b,), forward, {**batch, **drawn},
                                  self.cfg.clip_grad, lambda f, gnorm: {**f[1], "grad_norm": gnorm},
                                  capturable=not self.cfg.encoder_remat)

        return train_step


@dataclass
class TrainState:
    """Parameters live in `bundle`; `step` counts the updates taken."""

    step: int
    bundle: ModelBundle
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # update count -> learning rate
    params: list[torch.nn.Parameter]  # the optimizer's, in its order


def _filled_grads(params) -> list[torch.Tensor]:
    """The parameters' gradients, zeros where the backward left none
    (optax updates every leaf)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def _clip_gradients(grads, clip_grad: float) -> torch.Tensor:
    """Clip `grads` in place by their global norm (none for a clip of 0 or
    None); -> the norm before clipping."""
    gnorm = global_norm(grads)
    if clip_grad is not None and clip_grad > 0:
        clip_by_global_norm_(grads, clip_grad, gnorm)
    return gnorm.detach()


def _gradient_phases(state, clip_grad: float, metrics: Callable) -> list:
    """The phases after the backward, each in its span: in a process group
    `train_step.grad_sync` (`metrics(results)`' tensors and the gradients
    averaged over the ranks, in place), then `.clip` (the gradients filled,
    their norm, the clip; -> the norm) and `.update` (the optimizer's step).
    The all-reduce, the norm and the clip share one list of the gradients."""
    def sync(x, r):
        m = metrics(r)
        if m:
            parallel.all_reduce_mean_(list(m.values()))
        parallel.all_reduce_mean_(_filled_grads(state.params))

    phases = [("train_step.grad_sync", sync)] if parallel.active() else []
    return phases + [
        ("train_step.clip", lambda x, r: _clip_gradients(_filled_grads(state.params), clip_grad)),
        ("train_step.update", lambda x, r: state.optimizer.step())]


def apply_gradients(state: TrainState, clip_grad: float, metrics=None) -> torch.Tensor:
    """Average the gradients (and the `metrics`' tensors, in place) over
    the ranks of a process group, clip the gradients by their global norm,
    update at the schedule's rate for `state.step`, advance the step; -> the
    norm before clipping. Eager: the training step's phases after its
    backward."""
    set_lr(state.optimizer, state.schedule(state.step))
    results = graphs.eager(_gradient_phases(state, clip_grad, lambda r: metrics), {})
    state.step += 1
    return results[-2]


def _step_tensors(state) -> list:
    """The gradients, the optimizer's state and its learning rates."""
    opt = state.optimizer
    out = [p.grad for p in state.params]
    for p in state.params:
        out.extend(v for v in opt.state.get(p, {}).values() if isinstance(v, torch.Tensor))
    out.extend(g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor))
    return out


def run_train_step(state, step: str, modules, forward: Callable, inputs: dict,
                   clip_grad: float, outputs: Callable, capturable: bool = True):
    """One training step on `inputs` (name -> tensor or array), in its
    phases: `train_step.forward` (the gradients dropped, then
    `forward(inputs)` -> (loss, {metric: detached tensor}, ...)),
    `.backward`, then `_gradient_phases`, at the schedule's rate for
    `state.step`; advances the step; -> `outputs(forward's result, grad
    norm)`.

    Eager, or on the card replayed from CUDA graphs once the signature
    repeats (`graphs.run_step`, under the state's optimizer): not where the
    optimizer is not capturable (SGD) or `capturable` is False. The random
    draws are inputs, made before the step by the caller, so a replay uses
    exactly the eager step's. The rate is written before the phases run, so
    a replayed update reads the schedule's."""
    def fwd(x, r):
        state.optimizer.zero_grad(set_to_none=True)
        return forward(x)

    phases = [("train_step.forward", fwd),
              ("train_step.backward", lambda x, r: r[0][0].backward()),
              *_gradient_phases(state, clip_grad, lambda r: r[0][1])]
    set_lr(state.optimizer, state.schedule(state.step))
    capturable = capturable and all(g.get("capturable") for g in state.optimizer.param_groups)
    out = graphs.run_step(state.optimizer, step, modules, phases, inputs,
                          lambda r: outputs(r[0], r[-2]), lambda: _step_tensors(state),
                          baked=(clip_grad,), capturable=capturable)
    state.step += 1
    return out


def create_train_state(cfg: Options, seed: int = 0, steps_per_epoch: int = 1000,
                       device=None) -> TrainState:
    """Build the models from `seed` on `device` (CUDA unless given), load
    the ImageNet encoders when weights_init="pretrained" (reference
    train.py:142-190), and the optimizer over every trainable parameter."""
    bundle = build_bundle(cfg, seed, device)
    apply_pretrained(cfg, bundle)
    params = [p for p in bundle.parameters() if p.requires_grad]
    return TrainState(
        step=0, bundle=bundle, optimizer=make_optimizer(cfg, params),
        schedule=lr_schedule(cfg, steps_per_epoch), params=params,
    )


# -------------------------------------------------------------- eval forward
def single_frame_disp(bundle: ModelBundle, img) -> torch.Tensor:
    """Eval-mode disparity (B, 1, H, W) f32 of NCHW images on the bundle's
    device (evaluate_depth.py pipeline); on the card, replayed from a CUDA
    graph once its input signature repeats (`training/graphs.py`)."""
    bundle.eval()
    enc, dec = bundle.encoder, bundle.depth
    phases = (("single_frame_disp", lambda x, r: dec(enc(x[0]))[0].float()),)
    return graphs.run(bundle, "single_frame_disp", (enc, dec), phases, (img,))


def multi_frame_disp(bundle: ModelBundle, img_n1, img_0, img_p1) -> torch.Tensor:
    """Eval-mode fused disparity (B, 1, H, W) f32 (evaluate_depth_mf.py
    :179-188): frozen `vfi_test` flows (only_flow), one encoder pass over
    the 3B stack, fusion, then depth_mf (depth where there is none).

    The fusion warp reads the neighbours' maps straight out of the stacked
    pyramid through a use -> plane table (uses 0..B-1 read planes 0..B-1,
    uses B..2B-1 read planes 2B..3B-1), so the two neighbour pyramids are
    never concatenated; the values equal those of warping their concatenation.

    Its three phases run in the spans `multi_frame_disp.flow`, `.encoder`
    and `.fusion`; on the card each is replayed from its own CUDA graph once
    the input signature repeats (`training/graphs.py`)."""
    B = img_0.shape[0]
    bundle.eval()
    vfi, fusion = bundle.vfi_test, bundle.fusion_module
    # encoder_mf under separate_all, else the shared encoder
    encoder = getattr(bundle, "encoder_mf", bundle.encoder)
    depth_mf = getattr(bundle, "depth_mf", bundle.depth)

    def flow(x, r):
        embt = torch.full((B, 1, 1, 1), 0.5, device=x[1].device)
        return vfi(x[0], x[2], embt, only_flow=True)

    def fuse(x, r):
        (flows, feats), dev = r, x[1].device
        ids = image_ops.device_constant(tuple(range(B)) + tuple(range(2 * B, 3 * B)),
                                        torch.int32, dev)
        fused = fusion([f[B:2 * B] for f in feats],
                       (flows["flow0"].float(), flows["flow1"].float()), flows["mask"].float(),
                       (feats, ids))
        return depth_mf(fused)[0].float()

    phases = (("multi_frame_disp.flow", flow),
              ("multi_frame_disp.encoder", lambda x, r: encoder(torch.cat(x, 0))),
              ("multi_frame_disp.fusion", fuse))
    return graphs.run(bundle, "multi_frame_disp", (vfi, encoder, fusion, depth_mf), phases,
                      (img_n1, img_0, img_p1))
