"""The port's VFI training step against the benchmark's plain reference
(`perfbench/reference/training/vfi.py`) on the CPU at a tiny size (IFRNet
`tiny`, 64x96, B=2, f32) from the benchmark's seeded weights; IFRNet's
forward bit for bit against the reference's frozen copy of it; the step and
the flow-only forward unchanged by a running profiler, which sees the VFI
step's spans; IFRNet's spans in each of its three modes; and the
benchmark's FLOP count of the VFI step against the port's own."""

import copy

import pytest
import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models import ifrnet as TIF
from mono_vifi_tpu_torch.training.vfi import create_vfi_state, make_vfi_train_step
from mono_vifi_tpu_torch.utils import flops as port_flops
from perfbench import weights
from perfbench.counts import vfi as vfi_counts
from perfbench.drivers.train_vfi import make_pool
from perfbench.reference.config import Config
from perfbench.reference.models.ifrnet import IFRNet as RefIFRNet
from perfbench.reference.training import monovifi as ref_monovifi
from perfbench.reference.training import vfi as ref_vfi

B, H, W = 2, 64, 96
OPTS = {"height": H, "width": W, "batch_size": B, "vfi_scale": "tiny",
        "compute_dtype": "float32", "lr_sche_type": "cos", "learning_rate": 1e-4,
        "eta_min": 1e-5, "num_epochs": 150, "clip_grad": 5.0}
STEPS_PER_EPOCH = 2488
SPANS = ("train_step.forward", "train_step.backward", "ifrnet.encoder", "ifrnet.decoders",
         "ifrnet.image_warp", "ifrnet.loss")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """The port's VFI state with seed 7's benchmark weights, and two batches."""
    state = create_vfi_state(Options(**OPTS, device="cpu"), 0, STEPS_PER_EPOCH, "cpu")
    w = weights.draw(RefIFRNet("tiny"), 7, "cpu")
    weights.load(state.module, w)
    return state, w, make_pool(7, 2, B, H, W, (H, W), "cpu")


def planar(batch):
    return [batch[k].permute(0, 3, 1, 2).contiguous() for k in ("img0", "img1", "img2")]


def test_vfi_step_matches_the_reference(start):
    state, w, pool = copy.deepcopy(start)
    step = make_vfi_train_step(OPTS["clip_grad"])
    ref = RefIFRNet("tiny")
    weights.load(ref, w)
    params = dict(ref.named_parameters())
    opt = ref_monovifi.AdamW(params.values(), Config.from_keys(OPTS))
    total = STEPS_PER_EPOCH * OPTS["num_epochs"]
    for s in range(2):
        metrics, _ = step(state, pool[s])
        lr = ref_vfi.cosine_lr(s, OPTS["learning_rate"], OPTS["eta_min"], total)
        assert lr == state.schedule(s)
        loss, grads = ref_vfi.train_step(ref, opt, pool[s], lr)
        assert torch.allclose(metrics["loss"], loss, rtol=1e-6, atol=0), s
        for (name, p), g in zip(state.module.named_parameters(), grads):
            scale = g.abs().max().clamp_min(1e-12).item()
            assert torch.allclose(p.grad, g, rtol=1e-5, atol=1e-6 * scale), (s, name)
    assert state.step == 2
    for name, p in state.module.named_parameters():
        moved = (params[name] - w[name]).abs().max().clamp_min(1e-12).item()
        assert torch.allclose(p.detach(), params[name], rtol=0, atol=1e-4 * moved), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ifrnet_forward_is_the_references_bit_for_bit(start, dtype):
    """The port's IFRNet, spans included, computes what the
    reference's frozen copy of it computes: the depth cells' frozen VFI and
    the video's flows unchanged."""
    _, w, pool = start
    port, ref = TIF.IFRNet("tiny", dtype), RefIFRNet("tiny", dtype)
    weights.load(port, w)
    weights.load(ref, w)
    img0, img1, img2 = planar(pool[0])
    embt = torch.full((B, 1, 1, 1), 0.5)
    with torch.no_grad():
        for kw in ({"imgt": img1}, {}, {"only_flow": True}):
            a, b = port(img0, img2, embt, **kw), ref(img0, img2, embt, **kw)
            assert a.keys() == b.keys()
            for k in a:
                assert torch.equal(a[k], b[k]), (kw, k)


def profiled(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_profiler_changes_nothing_and_sees_the_vfi_spans(start):
    state, _, pool = start
    step = make_vfi_train_step(OPTS["clip_grad"])
    img0, _, img2 = planar(pool[1])
    embt = torch.full((B, 1, 1, 1), 0.5)

    def one_step():
        s = copy.deepcopy(state)
        metrics, aux = step(s, pool[0])
        with torch.no_grad():
            flows = s.module(img0, img2, embt, only_flow=True)
        return metrics, aux, flows, [p.detach() for p in s.params]

    plain = one_step()
    traced, names = profiled(one_step)
    for a, b in zip(plain[:3], traced[:3]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(plain[3], traced[3]))
    assert set(SPANS) <= names


@pytest.mark.parametrize("kw, names", [
    ({"imgt": True}, ("ifrnet.encoder", "ifrnet.decoders", "ifrnet.image_warp", "ifrnet.loss")),
    ({}, ("ifrnet.encoder", "ifrnet.decoders", "ifrnet.image_warp")),
    ({"only_flow": True}, ("ifrnet.encoder", "ifrnet.decoders", "ifrnet.image_warp")),
], ids=["loss", "frame", "flow"])
def test_ifrnet_spans_in_each_mode(start, kw, names):
    """The four parts in order, one of each, `ifrnet.loss` only given the
    middle frame: the depth step's frozen forward, the synthesis and the
    flows alone."""
    _, w, pool = start
    net = TIF.IFRNet("tiny")
    weights.load(net, w)
    img0, img1, img2 = planar(pool[0])
    if kw.get("imgt"):
        kw = {"imgt": img1}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        net(img0, img2, torch.full((B, 1, 1, 1), 0.5), **kw)
    seen = sorted((e.time_range.start, e.name) for e in prof.events()
                  if e.name.startswith("ifrnet."))
    assert tuple(name for _, name in seen) == names


def test_flop_count_equals_the_ports_count(start):
    state, _, pool = start
    img0, img1, img2 = planar(pool[0])
    embt = torch.full((B, 1, 1, 1), 0.5)
    module = copy.deepcopy(state.module)

    def step():
        module(img0, img2, embt, imgt=img1)["loss"].backward()

    assert vfi_counts.train_step(OPTS) == port_flops(step, grad=True)
