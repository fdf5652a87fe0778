"""The eval entries' CUDA graphs (mono_vifi_tpu_torch.training.graphs) and
the models' device constants (ops.image `device_constant`).

On the CPU: the cached constants give `embed_flow`, the fusion's level flow
and IFRNet's flows bit for bit what constants made afresh from host values
on every call give, in f32 and bf16; a second call of either entry at the
same shapes makes no constant; the entries never capture there and compute
exactly what the plain eager entries below compute.

On the card (marked `gpu`, skipped without CUDA): replay equals eager bit
for bit for both entries at batch 1 and 2, at the video's 640x192 in f32
with cuDNN held to deterministic algorithms (otherwise IFRNet's transposed
convolutions may take cuDNN's backward-data kernel with atomics, and two
eager calls differ by up to ~1e-6; a replay runs the eager call's kernels);
an in-place parameter update reaches the next replay; a replaced parameter
or a flipped TF32 flag starts the key again; a kept result is not
overwritten by the next call; the launch counters grow by as much for a
replayed call as for an eager one. This file imports no JAX, so:

    python -m pytest --noconftest -m gpu tests/test_torch_entry_graphs.py
"""

import contextlib
import math

import pytest
import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models import fusion as fusion_mod
from mono_vifi_tpu_torch.models import ifrnet as ifrnet_mod
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops import image as image_ops
from mono_vifi_tpu_torch.ops.image import resize_bilinear
from mono_vifi_tpu_torch.training import graphs
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training.factory import build_bundle

H, W = 64, 96
CPU_CFG = Options(height=H, width=W, compute_dtype="float32", fuse_model_type="shared_encoder",
                  vfi_test_scale="tiny", weights_init="scratch", device="cpu")
DTYPES = [torch.float32, torch.bfloat16]


def fresh_constant(values, dtype, device, make=None):
    """A constant made from host values on every call, as the models made
    them before the cache."""
    if make is not None:
        return make().to(device, dtype)
    return torch.tensor(list(values), dtype=dtype, device=device)


@contextlib.contextmanager
def fresh_constants():
    """A context in which the models make their constants afresh."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (image_ops, fusion_mod, ifrnet_mod):
            mp.setattr(mod, "device_constant", fresh_constant)
        yield


def embed_flow_fresh(x, num_freqs=10):
    n, K = x.shape[1], num_freqs
    freqs = torch.tensor([2.0**k for k in range(K) for _ in range(2 * n)],
                         dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    phase = torch.tensor(([0.0] * n + [math.pi / 2] * n) * K,
                         dtype=x.dtype, device=x.device).view(1, -1, 1, 1)
    return torch.cat([x, torch.sin(x.repeat(1, 2 * K, 1, 1) * freqs + phase)], dim=1)


def level_flow_fresh(flow, H, W):
    fh, fw = flow.shape[2:]
    scale = torch.tensor([W / fw, H / fh], dtype=flow.dtype,
                         device=flow.device).view(1, 2, 1, 1)
    return resize_bilinear(flow, (H, W)) * scale


def single_eager(bundle, img):
    """The single-frame entry without graphs."""
    bundle.eval()
    with torch.no_grad():
        return bundle.depth(bundle.encoder(img))[0].float()


def multi_eager(bundle, img_n1, img_0, img_p1):
    """The multi-frame entry without graphs or cached ids."""
    B = img_0.shape[0]
    bundle.eval()
    with torch.no_grad():
        embt = torch.full((B, 1, 1, 1), 0.5, device=img_0.device)
        flows = bundle.vfi_test(img_n1, img_p1, embt, only_flow=True)
        encoder = getattr(bundle, "encoder_mf", bundle.encoder)
        feats = encoder(torch.cat([img_n1, img_0, img_p1], 0))
        ids = torch.cat([torch.arange(B), torch.arange(2 * B, 3 * B)]).to(
            device=img_0.device, dtype=torch.int32)
        fused = bundle.fusion_module(
            [f[B:2 * B] for f in feats],
            (flows["flow0"].float(), flows["flow1"].float()), flows["mask"].float(),
            (feats, ids))
        return getattr(bundle, "depth_mf", bundle.depth)(fused)[0].float()


def images(B, seed, device="cpu", h=H, w=W):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand(B, 3, h, w, generator=gen).to(device) for _ in range(3)]


@pytest.fixture(scope="module")
def cpu_bundle():
    return build_bundle(CPU_CFG, seed=0, device="cpu", for_training=False)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cached_constants_match_fresh_ones(dtype):
    gen = torch.Generator().manual_seed(3)
    flow = (8 * torch.randn(2, 2, 32, 48, generator=gen)).to(dtype)
    x = resize_bilinear(flow, (16, 24)) * 0.5
    for _ in range(2):  # the first call fills the cache, the second reads it
        assert torch.equal(fusion_mod.embed_flow(x), embed_flow_fresh(x))
        got = fusion_mod.FusionModule._level_flow(flow, 8, 12)
        assert got.dtype == dtype and torch.equal(got, level_flow_fresh(flow, 8, 12))
    net = ifrnet_mod.IFRNet("tiny", dtype).eval()
    img0, img1, _ = (t.to(dtype) for t in images(2, 4))
    embt = torch.full((2, 1, 1, 1), 0.5, dtype=dtype)
    with torch.no_grad():
        cached = [net(img0, img1, embt, only_flow=True) for _ in range(2)]
        with fresh_constants():
            fresh = net(img0, img1, embt, only_flow=True)
    for out in cached:
        for k in ("flow0", "flow1", "mask"):
            assert out[k].dtype == dtype and torch.equal(out[k], fresh[k])


def test_entries_at_repeated_shapes_make_no_constant(cpu_bundle):
    imgs = images(2, 5)
    first = (TM.single_frame_disp(cpu_bundle, imgs[1]), TM.multi_frame_disp(cpu_bundle, *imgs))
    image_ops.reset_constant_counts()
    again = (TM.single_frame_disp(cpu_bundle, imgs[1]), TM.multi_frame_disp(cpu_bundle, *imgs))
    assert image_ops.CONSTANT_COUNTS == {"misses": 0}
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    image_ops.device_constant(("a key no model uses",), torch.float32, torch.device("cpu"),
                              lambda: torch.zeros(1))
    assert image_ops.CONSTANT_COUNTS == {"misses": 1}


@pytest.mark.parametrize("B", [1, 2])
def test_cpu_entries_run_eager_and_unchanged(cpu_bundle, B):
    imgs = images(B, 6 + B)
    with fresh_constants():
        sf_ref, mf_ref = single_eager(cpu_bundle, imgs[1]), multi_eager(cpu_bundle, *imgs)
    graphs.ENTRY_GRAPHS.clear()
    for _ in range(3):
        assert torch.equal(TM.single_frame_disp(cpu_bundle, imgs[1]), sf_ref)
        assert torch.equal(TM.multi_frame_disp(cpu_bundle, *imgs), mf_ref)
    assert graphs.ENTRY_GRAPHS == {("single_frame_disp", "eager"): 3,
                                   ("multi_frame_disp", "eager"): 3}


# ------------------------------------------------------------------ the card

VIDEO_CFG = Options(backbone="ResNet18", height=192, width=640, compute_dtype="float32",
                    fuse_model_type="shared_encoder", vfi_test_scale="small",
                    weights_init="scratch", device="cuda")


@pytest.fixture(scope="module")
def card():
    """The video's evaluation bundle on the card, f32 with TF32 off and
    cuDNN's algorithms deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = torch.backends
    flags = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = True
    yield build_bundle(VIDEO_CFG, seed=0, device="cuda", for_training=False)
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic = flags


def card_images(B, seed):
    return images(B, seed, "cuda", 192, 640)


def entries(bundle, imgs):
    return TM.single_frame_disp(bundle, imgs[1]), TM.multi_frame_disp(bundle, *imgs)


def eager(bundle, imgs):
    return single_eager(bundle, imgs[1]), multi_eager(bundle, *imgs)


def counts(kind):
    return tuple(graphs.ENTRY_GRAPHS[e, kind] for e in ("single_frame_disp", "multi_frame_disp"))


def assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
def test_replay_equals_eager_on_the_card(card, B):
    graphs.ENTRY_GRAPHS.clear()
    for i in range(4):  # eager, capture, replay, replay
        imgs = card_images(B, 10 * B + i)
        assert_equal(entries(card, imgs), eager(card, imgs))
    assert (counts("eager"), counts("capture"), counts("replay")) == ((1, 1), (1, 1), (2, 2))


@pytest.mark.gpu
def test_parameter_updates_and_replacements_on_the_card(card):
    imgs = card_images(1, 30)
    for _ in range(2):
        entries(card, imgs)
    graphs.ENTRY_GRAPHS.clear()
    w = card.encoder.encoder.conv1.weight
    with torch.no_grad():
        w.mul_(0.9)  # in place: the next call replays with the new values
    assert_equal(entries(card, imgs), eager(card, imgs))
    assert counts("replay") == (1, 1) and counts("eager") == (0, 0)
    card.encoder.encoder.conv1.weight = torch.nn.Parameter(w.detach().clone())
    graphs.ENTRY_GRAPHS.clear()
    for kind in ("eager", "capture", "replay"):  # a new storage: the key starts again
        assert_equal(entries(card, imgs), eager(card, imgs))
        assert counts(kind) == (1, 1)
    torch.backends.cudnn.allow_tf32 = True
    try:
        graphs.ENTRY_GRAPHS.clear()
        for kind in ("eager", "capture", "replay"):
            assert_equal(entries(card, imgs), eager(card, imgs))
            assert counts(kind) == (1, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    graphs.ENTRY_GRAPHS.clear()
    entries(card, imgs)
    assert counts("replay") == (1, 1)  # the TF32-off graphs are still held


@pytest.mark.gpu
def test_kept_results_and_launch_counts_on_the_card(card):
    graphs.ENTRY_GRAPHS.clear()
    kept, grown = [], []
    for i in range(4):
        before = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
        out = entries(card, card_images(1, 40 + i))
        torch.cuda.synchronize()
        grown.append(({k: v - before[0][k] for k, v in cuda.LAUNCHES.items()},
                      {k: v - before[1].get(k, 0) for k, v in cuda.LAUNCH_SHAPES.items()
                       if v != before[1].get(k, 0)}))
        kept.append((out, [o.clone() for o in out]))
    assert min(counts("replay")) >= 2
    assert grown[0][0]["bilinear_sample_table"] == 5
    assert all(g == grown[0] for g in grown)
    for out, copy in kept:
        assert_equal(out, copy)


@pytest.mark.gpu
def test_flop_count_runs_eager_on_the_card(card):
    """A call under a dispatch mode (here a FLOP count) runs eager, so the
    mode sees every operation, though the key has graphs."""
    from torch.utils.flop_counter import FlopCounterMode

    imgs = card_images(1, 50)
    for _ in range(2):
        entries(card, imgs)
    graphs.ENTRY_GRAPHS.clear()
    with FlopCounterMode(display=False) as counter:
        entries(card, imgs)
    assert counts("eager") == (1, 1) and counts("replay") == (0, 0)
    assert counter.get_total_flops() > 0
