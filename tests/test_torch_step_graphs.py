"""The training steps' CUDA graphs (mono_vifi_tpu_torch.training.graphs
`run_step`, through `MonoViFiStep.make_train_step` and
`make_vfi_train_step`), on the card.

Two states built alike are stepped side by side for 5 steps: one through
the step (eager, capture, then 3 replays), one through the step's phases
written out eagerly here, as the step ran before it replayed. Before each
step after the first the eager state takes the other's parameters, buffers
and AdamW moments (copied in place), so both take every step from one
state. Then the loss terms and the BatchNorm statistics, which the forward
makes, agree bit for bit (cuDNN held to deterministic algorithms); the
gradient norm within 1e-4 relative; the first gradient, each step's
change of the parameters and the AdamW moments within the limits of the
benchmark's `correct` (PERF.md section 2), read as it reads them (the norm
of each leaf). Nothing closer holds between two runs of one eager step:
the splat kernel's atomics and the feature warps' backward sum in an order
that varies from run to run, and the bf16 gradients round the difference
up to a unit in their last place.

Also: `STEP_GRAPHS` counts 1 eager, 1 capture and 3 replays; metrics kept
from an earlier step are not overwritten by later replays; the port's
launches counted a step, and the (entry point, kernel, shape) sequence a
wrapper on `ops.cuda.launch` sees, are the eager step's on a replay; a
`step` boundary and a cosine schedule crossed between replays change the
rate the update applies; `optimizer.load_state_dict` or a parameter given
a new storage starts the key again; an SGD state, a FLOP count, a process
group of one rank and `encoder_remat` stay eager; a replayed LiteMono step,
its drop masks drawn before it, makes no stream synchronisation. This file
imports no JAX, so:

    python -m pytest --noconftest -m gpu tests/test_torch_step_graphs.py
"""

import collections
import copy
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mono_vifi_tpu_torch.bench import make_batch
from mono_vifi_tpu_torch.config import parse_options
from mono_vifi_tpu_torch.data.synthetic import _panning_field
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.training import graphs
from mono_vifi_tpu_torch.training import monovifi as M
from mono_vifi_tpu_torch.training import vfi as V
from mono_vifi_tpu_torch.training.optim import lr_schedule

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = {"ResNet18": "configs/resnet18/ResNet18_KITTI_MR.txt",
           "DHRNet": "configs/dhrnet/DHRNet_KITTI_MR.txt",
           "VFI": "configs/vfi/IFRNet_L_KITTI.txt",
           "LiteMono": "configs/litemono/LiteMono_KITTI_MR.txt"}
# PERF.md section 2: the worst leaf's first-gradient gap and change gap
# that `correct` allows in each cell
GRAD_LIMIT = {"ResNet18": 0.01, "DHRNet": 0.08, "VFI": 5e-3, "LiteMono": 0.04}
CHANGE_LIMIT = {"ResNet18": 0.2, "DHRNet": 0.45, "VFI": 2e-3, "LiteMono": 0.45}
TERMS = ("loss", "loss_base", "loss_dc", "loss_sadc")
STEPS = 5
VFI_CROP = (160, 576)  # the KITTI VFI training crop
PAN = 8  # pixels between a VFI triplet's frames


@pytest.fixture(scope="module")
def card():
    """The card, with cuDNN's algorithms deterministic and its autotuner
    off, so that two forwards of one state agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = torch.backends.cudnn
    flags = b.deterministic, b.benchmark
    b.deterministic, b.benchmark = True, False
    yield torch.device("cuda")
    b.deterministic, b.benchmark = flags


def options(name: str, *extra: str):
    return parse_options(["-c", str(ROOT / CONFIGS[name]), "--weights_init", "scratch",
                          "--device", "cuda", *extra])


class Depth:
    """A depth configuration's state, step and batches."""

    def __init__(self, cfg, card):
        self.cfg = cfg
        self.state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=card)
        self.step = M.MonoViFiStep(self.state.bundle, device=card)
        self.train_step = self.step.make_train_step()
        self.module = self.state.bundle
        self.card = card

    def batch(self, i: int):
        return make_batch(self.cfg.batch_size, self.cfg.height, self.cfg.width, self.card,
                          seed=i)

    def gen(self, i: int):
        return torch.Generator(device=self.card).manual_seed(100 + i)

    def call(self, batch, i):
        """The step as its callers call it; -> its metrics."""
        return self.train_step(self.state, batch, self.gen(i))

    def eager(self, batch, i):
        """The step's phases written out, without graphs."""
        st, cfg = self.state, self.cfg
        noise = self.step.draw_noise(cfg.batch_size, cfg.height, cfg.width, self.gen(i))
        st.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.step.loss_fn(batch, noise=noise)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = M.apply_gradients(st, cfg.clip_grad)
        return metrics


class VFI(Depth):
    """IFRNet-L's training state, step and batches."""

    def __init__(self, cfg, card):
        self.cfg = cfg
        self.state = V.create_vfi_state(cfg, seed=0, steps_per_epoch=2488, device=card)
        self.train_step = V.make_vfi_train_step(cfg.clip_grad)
        self.module = self.state.module
        self.card = card

    def batch(self, i: int):
        """B triplets, each three windows PAN pixels apart of a smooth
        colour field of its own."""
        rng = np.random.default_rng(200 + i)
        B, (h, w) = self.cfg.batch_size, VFI_CROP
        fields = [_panning_field(rng, h, w + 2 * PAN) for _ in range(B)]
        batch = {f"img{t}": torch.from_numpy(np.stack([f[:, PAN * t:PAN * t + w] for f in fields]))
                 .to(self.card).float() / 255.0 for t in range(3)}
        batch["embt"] = torch.full((B,), 0.5, device=self.card)
        return batch

    def call(self, batch, i):
        return self.train_step(self.state, batch)[0]

    def eager(self, batch, i):
        st = self.state
        b = M.prepare_batch(batch, self.card)
        st.optimizer.zero_grad(set_to_none=True)
        out = st.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1), imgt=b["img1"])
        out["loss"].backward()
        grad_norm = M.apply_gradients(st, self.cfg.clip_grad)
        mse = torch.mean((out["imgt_pred"].detach() - b["img1"]) ** 2)
        return {"loss": out["loss"].detach(), "psnr": -10.0 * torch.log10(mse + 1e-12),
                "grad_norm": grad_norm}


def build(name: str, card, *extra: str):
    cfg = options(name, *extra)
    return (VFI if name == "VFI" else Depth)(cfg, card)


def moments(side) -> dict:
    opt = side.state.optimizer
    return {f"{i}.{k}": v for i, p in enumerate(side.state.params)
            for k, v in opt.state.get(p, {}).items()}


def take_state(dst, src) -> None:
    """`dst`'s parameters, buffers and AdamW moments (once it has them) set
    to `src`'s, in place (their storages kept)."""
    with torch.no_grad():
        for a, b in zip(dst.module.state_dict().values(), src.module.state_dict().values()):
            a.copy_(b)
        mine = moments(dst)
        for k, v in moments(src).items() if mine else ():
            mine[k].copy_(v)
    dst.state.step = src.state.step


def norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def norm_gap(got: dict, want: dict, leaves=None) -> tuple[float, str]:
    """As `correct` reads a gap: the largest gap between two norms of a
    leaf, over the larger of `want`'s norm of that leaf and of the median
    leaf; -> (gap, leaf). `leaves` limits the leaves compared."""
    median = sorted(want.values())[len(want) // 2]
    return max((abs(got[k] - want[k]) / max(want[k], median, 1e-30), k)
               for k in (want if leaves is None else leaves))


def diff_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest norm of a leaf's difference, over the larger of
    `want`'s norm of that leaf and of the median leaf; -> (gap, leaf)."""
    want_norms = norms(want)
    median = sorted(want_norms.values())[len(want_norms) // 2]
    return max((float((got[k].float() - v.float()).norm()) / max(want_norms[k], median, 1e-30), k)
               for k, v in want.items())


def first_grads(side, beta1: float) -> dict:
    """The first gradient as AdamW holds it after one update."""
    return {k: v / (1 - beta1) for k, v in moments(side).items() if k.endswith("exp_avg")}


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def launches_of(fn) -> tuple:
    """What `fn()` adds to `LAUNCH_SHAPES`, and the (entry point, kernel,
    shape) sequence a wrapper put on `ops.cuda.launch` as perfbench's trace
    puts its own sees."""
    seen, launch = [], cuda.launch

    def wrapper(fn_name, kernel, *args, shape):
        seen.append((fn_name, kernel, tuple(shape)))
        return launch(fn_name, kernel, *args, shape=shape)

    before = collections.Counter(cuda.LAUNCH_SHAPES)
    cuda.launch = wrapper
    try:
        out = fn()
    finally:
        cuda.launch = launch
    torch.cuda.synchronize()
    return out, collections.Counter(cuda.LAUNCH_SHAPES) - before, seen


def counts(step: str) -> tuple:
    return tuple(graphs.STEP_GRAPHS[step, k] for k in ("eager", "capture", "replay"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CONFIGS))
def test_replayed_steps_match_eager_steps(card, name):
    a, b = build(name, card), build(name, card)
    step = "vfi" if name == "VFI" else "monovifi"
    names = [k for k, p in a.module.named_parameters() if p.requires_grad]

    def trained(side) -> dict:
        params = dict(side.module.named_parameters())
        return {k: params[k].detach().clone() for k in names}

    def change(side, start) -> dict:
        return norms({k: v - start[k] for k, v in trained(side).items()})

    graphs.STEP_GRAPHS.clear()
    kept, readings = [], {}
    for i in range(STEPS):
        batch = a.batch(i)
        take_state(b, a)
        start = trained(a)
        got, grown, seen = launches_of(lambda: a.call(batch, i))
        want, want_grown, want_seen = launches_of(lambda: b.eager(batch, i))
        assert grown == want_grown and seen == want_seen, i
        assert a.state.step == b.state.step == i + 1
        kept.append((got, {k: v.clone() for k, v in got.items()}))
        for k in want:
            if k != "grad_norm":
                assert torch.equal(got[k], want[k]), (i, k, float(got[k]), float(want[k]))
        assert rel(float(got["grad_norm"]), float(want["grad_norm"])) <= 1e-4, i
        buffers = dict(b.module.named_buffers())
        for k, v in a.module.named_buffers():
            assert torch.equal(v, buffers[k]), (i, k)
        if i == 0:
            readings["grad_gap"] = norm_gap(norms(first_grads(a, a.cfg.beta1)),
                                            norms(first_grads(b, b.cfg.beta1)))
        else:
            readings[f"moments_{i}"] = diff_gap(moments(a), moments(b))
        readings[f"change_{i}"] = norm_gap(change(a, start), change(b, start))
    print(name, readings)
    assert readings["grad_gap"][0] <= GRAD_LIMIT[name], readings
    for i in range(STEPS):
        assert readings[f"change_{i}"][0] <= CHANGE_LIMIT[name], readings
        if i:
            assert readings[f"moments_{i}"][0] <= GRAD_LIMIT[name], readings
    assert counts(step) == (1, 1, STEPS - 2)
    for out, copy_ in kept:
        assert all(torch.equal(out[k], copy_[k]) for k in out)


@pytest.mark.gpu
def test_replayed_litemono_step_makes_no_stream_sync(card):
    """Under `torch.cuda.set_sync_debug_mode("error")` the replayed steps,
    with the drop masks and the automask noise drawn inside each call, would
    raise on a synchronising call that the mode detects (a blocking copy
    from host memory among them, as the keep rates once made): none runs,
    so a replay is queued behind the one before it."""
    side = build("LiteMono", card, "--batch_size", "2")
    batch = side.batch(0)
    for i in range(2):  # eager, then capture
        side.call(batch, i)
    gens = [side.gen(i) for i in range(2, 5)]
    torch.cuda.synchronize()
    graphs.STEP_GRAPHS.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = [side.train_step(side.state, batch, g) for g in gens]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counts("monovifi") == (0, 0, 3)
    assert all(math.isfinite(float(m["loss"])) for m in out)


@pytest.mark.gpu
def test_schedules_crossed_between_replays(card):
    """A `step` schedule whose rate drops to 0 at update 3 leaves the
    parameters bit for bit as they were through the replays after it,
    having moved them before; under a cosine schedule down to a tenth over
    5 updates each replay's change matches the eager step's from the same
    state."""
    B = 4
    a, b = build("VFI", card, "--batch_size", str(B)), build("VFI", card, "--batch_size", str(B))
    drop = lr_schedule(dataclasses.replace(a.cfg, lr_sche_type="step", decay_step=[3],
                                           decay_rate=0.0), steps_per_epoch=1)
    cos = lr_schedule(dataclasses.replace(a.cfg, eta_min=a.cfg.learning_rate / 10,
                                          num_epochs=STEPS - 1), steps_per_epoch=1)
    gaps = []
    for schedule in (drop, cos):
        for side in (a, b):
            side.state.schedule = schedule
            side.state.step = 0
        graphs.STEP_GRAPHS.clear()
        for i in range(STEPS):
            batch = a.batch(10 + i)
            take_state(b, a)
            start = [p.detach().clone() for p in a.state.params]
            a.call(batch, i)
            b.eager(batch, i)
            lr = a.state.optimizer.param_groups[0]["lr"]
            assert float(lr) == float(torch.tensor(schedule(i), dtype=torch.float32)), i
            moved = sum(not torch.equal(p, s) for p, s in zip(a.state.params, start))
            if schedule is drop:
                assert moved == 0 if i >= 3 else moved > len(start) // 2, i
                continue
            gaps.append(norm_gap(
                norms({str(k): p.detach() - s for k, (p, s) in enumerate(zip(a.state.params, start))}),
                norms({str(k): p.detach() - s for k, (p, s) in enumerate(zip(b.state.params, start))})))
        assert counts("vfi") == ((1, 1, 3) if schedule is drop else (0, 0, 5))
    print("cos change gaps", gaps)
    assert max(gaps)[0] <= CHANGE_LIMIT["VFI"], gaps


@pytest.mark.gpu
def test_replaced_storages_start_the_key_again(card):
    side = build("VFI", card, "--batch_size", "4")
    batch = side.batch(0)
    for i in range(3):
        side.call(batch, i)
    graphs.STEP_GRAPHS.clear()
    opt = side.state.optimizer
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # new moments, a new rate
    for kind in ("eager", "capture", "replay"):
        side.call(batch, 0)
        assert graphs.STEP_GRAPHS["vfi", kind] == 1, dict(graphs.STEP_GRAPHS)
    p = side.state.params[0]
    with torch.no_grad():
        p.data = p.data.clone()  # the same parameter with a new storage
    graphs.STEP_GRAPHS.clear()
    for i in range(3):
        side.call(batch, i)
    assert counts("vfi") == (1, 1, 1)
    # a state saved to a file and read onto the host: its rate comes back as
    # a host tensor and is put on the card again
    opt.load_state_dict(torch.load(_saved(opt.state_dict()), map_location="cpu",
                                   weights_only=True))
    graphs.STEP_GRAPHS.clear()
    for i in range(3):
        metrics = side.call(batch, i)
    assert counts("vfi") == (1, 1, 1) and math.isfinite(float(metrics["loss"]))
    assert opt.param_groups[0]["lr"].device.type == "cuda"


def _saved(obj):
    import io

    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


@pytest.mark.gpu
def test_uncapturable_steps_stay_eager(card, tmp_path):
    """An SGD state, a call under a FLOP count, a process group of one
    rank and `encoder_remat` run every call eager."""
    from torch.utils.flop_counter import FlopCounterMode

    sgd = build("VFI", card, "--batch_size", "4", "--optimizer", "sgd")
    batch = sgd.batch(0)
    graphs.STEP_GRAPHS.clear()
    for i in range(3):
        sgd.call(batch, i)
    assert counts("vfi") == (3, 0, 0)

    side = build("VFI", card, "--batch_size", "4")
    for i in range(3):
        side.call(batch, i)
    graphs.STEP_GRAPHS.clear()
    with FlopCounterMode(display=False) as flops:
        side.call(batch, 3)
    assert counts("vfi") == (1, 0, 0) and flops.get_total_flops() > 0

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        graphs.STEP_GRAPHS.clear()
        for i in range(3):
            side.call(batch, i)
        assert counts("vfi") == (3, 0, 0)
    finally:
        dist.destroy_process_group()

    cfg = dataclasses.replace(options("ResNet18", "--batch_size", "2"), encoder_remat=True)
    remat = Depth(cfg, card)
    graphs.STEP_GRAPHS.clear()
    for i in range(3):
        m = remat.call(remat.batch(0), i)
    assert counts("monovifi") == (3, 0, 0) and math.isfinite(float(m["loss"]))
