"""The port's ResNet50, LiteMono and D-HRNet against the JAX package on the
CPU (64x96, batch 2, f32), on the same weights: the port's random weights
(BatchNorm statistics and LiteMono's layer scales drawn from a numpy seed,
so that every branch counts) carried into Flax by the
JAX package's own torch -> Flax converter.

Covered per backbone: the encoder in eval mode and in train mode with its
updated BatchNorm statistics (LiteMono with stochastic depth at rate 0, and
at its default rates with injected keep masks), the decoder, the fusion
module at the backbone's levels (plain and table paths), the port's
Flax -> port converter round trip, `apply_pretrained` on synthetic ImageNet
files in the reference files' key layouts, and a JAX weight-only `.pkl`
read into the port.

Tolerances (f32, CPU): encoder features and disparities atol 3e-4 of
values scaled to at most 1 (tests/test_models2.py), taken relative to the
largest |value| of a deeper feature map; in train mode 1e-3 of it, because
BatchNorm over batch statistics at the deepest levels (12 values a channel
at 2x3 pixels and batch 2) amplifies the two packages' rounding differences
(ResNet50 reads 3.4e-4); BatchNorm running statistics atol 2e-5 and rtol
1e-4 (tests/test_torch_step.py holds ResNet18's to atol 1e-5): the deep
levels' batch statistics come from features that already carry those
differences, through 50 layers (ResNet50) or four fusing stages (D-HRNet):
up to 1.1e-5 absolute on a mean and 3.8e-5 relative on a variance near 1.
A wrong variance rule (biased against unbiased) moves a variance by 1/n,
8% at the deepest level. D-HRNet's JAX encoder folds samples into
channels on the TPU path and takes its BatchNorm variance as E[x^2] -
E[x]^2 (ops/blockconv.py BlockBatchNorm), the port in two passes: the two
differ by rounding only. The fusion module atol 2e-4, as
tests/test_torch_models.py. Converted and loaded weights bit for bit.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import flax.linen as fnn

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.models import fusion as JF
from mono_vifi_tpu.models import litemono as JL
from mono_vifi_tpu.training import checkpoint as jckpt
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu.training.pretrained import apply_pretrained as japply_pretrained
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models import litemono as TL
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training.factory import build_bundle
from mono_vifi_tpu_torch.training.pretrained import IMAGENET_FILES, apply_pretrained
from tests.test_torch_parallel import torch_default_init

B, H, W = 2, 64, 96
BACKBONES = ("ResNet50", "LiteMono", "DHRNet")
ATOL, TRAIN_ATOL, STATS_ATOL, STATS_RTOL = 3e-4, 1e-3, 2e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and
    a process whose eight OpenMP threads wait on busy cores spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def kw(backbone, **extra):
    return dict(backbone=backbone, height=H, width=W, batch_size=B, use_affine=True,
                compute_dtype="float32", fuse_model_type="shared_encoder",
                vfi_train_scale="tiny", vfi_test_scale="tiny") | extra


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def perturb(module, seed):
    """BatchNorm statistics and LiteMono's layer scales from a numpy seed (at
    init the statistics are 0 / 1 and the scales 1e-6)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.rsplit(".", 1)[-1] in ("gamma", "gamma_xca"):
                p.copy_(torch.from_numpy(rng.uniform(0.3, 0.8, p.shape).astype(np.float32)))
        for m in module.modules():
            if hasattr(m, "running_mean"):
                m.running_mean.copy_(torch.from_numpy(
                    (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    return module


def np_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def to_jax(backbone, role, sd, num_levels=None):
    """One role's port state_dict -> JAX {params, batch_stats}, through the
    JAX package's converter."""
    if role in ("encoder", "encoder_mf"):
        if backbone == "LiteMono":
            return jconvert.convert_litemono_encoder(sd)
        if backbone == "DHRNet":
            return jconvert.convert_hrnet(sd, prefix="encoder.")
        return jconvert.convert_depth_encoder(sd, 50 if backbone == "ResNet50" else 18)
    if role in ("depth", "depth_mf"):
        if backbone == "LiteMono":
            return jconvert.convert_litemono_decoder(sd, scales=(0,))
        if backbone == "DHRNet":
            return jconvert.convert_dhrnet_decoder(sd)
        return jconvert.convert_depth_decoder(sd)
    if role == "fusion_module":
        return jconvert.convert_fusion_module(sd, num_levels)
    if role == "pose_encoder":
        return jconvert.convert_pose_encoder(sd, 18)
    return jconvert.convert_pose_decoder(sd)


def jax_trees(backbone, bundle):
    """(params, batch_stats) of every trainable role of a port bundle."""
    params, bstats = {}, {}
    for role, m in bundle.trainable_roles().items():
        v = to_jax(backbone, role, np_sd(m), len(bundle.num_ch_enc))
        params[role] = v["params"]
        if v["batch_stats"]:
            bstats[role] = v["batch_stats"]
    return params, bstats


@pytest.fixture(scope="module", params=BACKBONES)
def nets(request):
    """The port's bundle (torch's default init, perturbed: see
    tests/test_torch_parallel.py torch_default_init), the JAX bundle and
    the JAX trees."""
    backbone = request.param
    with torch_default_init():
        bundle = perturb(build_bundle(Options(**kw(backbone)), 3, "cpu"), 11)
    params, bstats = jax_trees(backbone, bundle)
    return backbone, bundle, JM.ModelBundle(JOptions(**kw(backbone))), params, bstats


def images(seed=4, n=B):
    return np.random.default_rng(seed).random((n, H, W, 3)).astype(np.float32)


def assert_features(got, ref, train=False):
    """atol 3e-4 (train mode: 1e-3) of the largest |value| of the deeper
    maps (at least 1)."""
    scale = max(1.0, max(float(np.abs(r).max()) for r in ref[1:]))
    scale *= TRAIN_ATOL / ATOL if train else 1.0
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (i, g.shape, r.shape)
        np.testing.assert_allclose(g, r, atol=ATOL * scale, err_msg=f"level {i}")


def run_port_encoder(enc, x, train, masks=None):
    enc.train(train)
    with torch.no_grad():
        args = (nchw(x),) if masks is None else (nchw(x), torch.from_numpy(masks))
        return [nhwc(f) for f in enc(*args)]


def drop_interceptor(masks, depth):
    """Replace the JAX DropPath's own Bernoulli draws by the given keep
    masks (blocks, N): block stage<i>_<j> takes row sum(depth[:i]) + j."""
    starts = np.cumsum((0,) + tuple(depth))

    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if not (isinstance(m, JL.DropPath) and context.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        x = args[0]
        train = args[1] if len(args) > 1 else kwargs.get("train", False)
        if not train or m.rate == 0.0:
            return x
        i, j = (int(t) for t in m.scope.path[-2][len("stage"):].split("_"))
        keep = jnp.asarray(masks[starts[i] + j]).reshape(-1, 1, 1, 1)
        return jnp.where(keep, x / (1.0 - m.rate), 0.0)

    return fnn.intercept_methods(interceptor)


def run_jax_encoder(module, params, bstats, x, train):
    v = {"params": params, "batch_stats": bstats}
    if not train:
        return [np.asarray(f) for f in module.apply(v, jnp.asarray(x), train=False)], None
    feats, mut = module.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    return [np.asarray(f) for f in feats], mut["batch_stats"]


def assert_stats(enc, backbone, params, new_bstats):
    """The port encoder's running statistics against the JAX update, carried
    over by the port's Flax -> port converter."""
    want = convert.BACKBONES[backbone][0](params, jax.tree.map(np.asarray, new_bstats))
    got = enc.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_matches_jax(nets, train):
    """Eval mode, and train mode with the updated BatchNorm statistics
    (LiteMono with stochastic depth at rate 0 on both sides)."""
    backbone, bundle, jb, params, bstats = nets
    enc, jenc = bundle.encoder, jb.encoder
    if train and backbone == "LiteMono":
        enc = TL.DepthEncoder(height=H, width=W, drop_path_rate=0.0)
        enc.load_state_dict(bundle.encoder.state_dict())
        jenc = JL.DepthEncoder(height=H, width=W, drop_path_rate=0.0)
    else:
        enc = copy.deepcopy(enc)  # the bundle keeps its statistics
    x = images()
    ref, new_bstats = run_jax_encoder(jenc, params["encoder"], bstats["encoder"], x, train)
    got = run_port_encoder(enc, x, train)
    assert_features(got, ref, train)
    if train:
        assert_stats(enc, backbone, params["encoder"], new_bstats)


def test_litemono_drop_path_masks_match_jax():
    """Train mode at the default rates (0 .. 0.2), the same per-sample keep
    masks injected into both packages (the JAX side through an interceptor
    in place of its own draws), about a fifth of them dropping."""
    with torch_default_init():
        bundle = perturb(build_bundle(Options(**kw("LiteMono")), 5, "cpu"), 12)
    params, bstats = jax_trees("LiteMono", bundle)
    enc = bundle.encoder
    masks = np.random.default_rng(6).random((enc.num_drop_paths, B)) >= 0.2
    assert not masks.all()
    x = images(7)
    with drop_interceptor(masks, TL._MODELS["lite-mono"]["depth"]):
        ref, new_bstats = run_jax_encoder(JL.DepthEncoder(height=H, width=W),
                                          params["encoder"], bstats["encoder"], x, True)
    got = run_port_encoder(enc, x, True, masks)
    assert_features(got, ref, True)
    assert_stats(enc, "LiteMono", params["encoder"], new_bstats)
    # a missing mask is refused in training, not taken as "keep everything"
    with pytest.raises(ValueError, match="keep mask"):
        enc.train()(nchw(x))


def test_decoder_matches_jax(nets):
    backbone, bundle, jb, params, _ = nets
    rng = np.random.default_rng(9)
    enc_shapes = [f.shape for f in bundle.encoder.eval()(torch.zeros(1, 3, H, W))]
    feats = [rng.random((B, h, w, c)).astype(np.float32) for _, c, h, w in enc_shapes]
    ref = np.asarray(jb.depth.apply({"params": params["depth"]},
                                    [jnp.asarray(f) for f in feats])[0])
    with torch.no_grad():
        got = nhwc(bundle.depth([nchw(f) for f in feats])[0])
    assert got.shape == ref.shape == (B, H, W, 1)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("layout", ["training", "inference"])
def test_fusion_matches_jax(nets, layout):
    """The fusion module at the backbone's levels and channels (LiteMono:
    three levels from 1/4 resolution, its level-0 flow halved once more),
    through the training step's unique table and through the multi-frame
    inference's (the 3B stack itself), against the JAX package's fusion on
    the concatenated neighbour pyramids."""
    backbone, bundle, jb, params, _ = nets
    rng = np.random.default_rng(10)
    shapes = [f.shape for f in bundle.encoder.eval()(torch.zeros(1, 3, H, W))]
    L = len(shapes)
    uniq = [[rng.random((B, h, w, c)).astype(np.float32) for _, c, h, w in shapes]
            for _ in range(3)]
    if layout == "training":
        uses = TM.TABLE_USES
        prev = [np.concatenate([uniq[u][i] for u in uses[:3]], 0) for i in range(L)]
        nxt = [np.concatenate([uniq[u][i] for u in uses[3:]], 0) for i in range(L)]
        center = [np.concatenate([uniq[0][i]] * 3, 0) for i in range(L)]
    else:
        uses = (0, 2)
        prev, center, nxt = uniq
    n = len(uses) // 2 * B
    fl_n1, fl_p1 = (rng.uniform(-2, 2, (n, H, W, 2)).astype(np.float32) for _ in range(2))
    mask = rng.random((n, H, W, 1)).astype(np.float32)
    ref = JF.FusionModule(num_ch_enc=bundle.num_ch_enc, backbone=backbone).apply(
        {"params": params["fusion_module"]},
        [[jnp.asarray(f) for f in p] for p in (prev, center, nxt)],
        (jnp.asarray(fl_n1), jnp.asarray(fl_p1)), jnp.asarray(mask))
    unique = [torch.cat([nchw(uniq[u][i]) for u in range(3)], 0) for i in range(L)]
    ids = torch.tensor([u * B + j for u in uses for j in range(B)], dtype=torch.int32)
    with torch.no_grad():
        got = bundle.fusion_module([nchw(f) for f in center], (nchw(fl_n1), nchw(fl_p1)),
                                   nchw(mask), (unique, ids))
    assert len(got) == len(ref) == L
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4)


def test_converter_round_trip(nets):
    """Port -> JAX (the JAX package's converter) -> port (the port's) gives
    every role's state_dict back bit for bit, the fusion module's level
    count read from the tree."""
    backbone, bundle, _, params, bstats = nets
    back = convert.bundle_state_dicts(params, bstats, backbone=backbone)
    assert set(back) == set(bundle.trainable_roles())
    for role, m in bundle.trainable_roles().items():
        want = m.state_dict()
        assert set(back[role]) == set(want), role
        for k, v in want.items():
            assert torch.equal(back[role][k], v), f"{role}.{k}"


def imagenet_file(backbone, bundle, rng):
    """A synthetic ImageNet file in the reference file's key layout: the
    torchvision layout with its classifier (ResNet50), the HRNet
    classification checkpoint's unprefixed keys with its heads (DHRNet),
    LiteMono's ['model'] with its final norm and head."""
    def rand_like(v):
        if v.dtype != torch.float32:
            return v.clone()
        a = rng.standard_normal(v.shape) * 0.1
        return torch.from_numpy((np.abs(a) + 0.5 if v.dim() == 1 else a).astype(np.float32))

    sd = {k: rand_like(v) for k, v in bundle.encoder.state_dict().items()}
    if backbone == "LiteMono":
        head = {"norm.weight": torch.ones(128), "norm.bias": torch.zeros(128),
                "head.weight": torch.zeros(1000, 128), "head.bias": torch.zeros(1000)}
        return {"model": sd | head}
    sd = {k[len("encoder."):]: v for k, v in sd.items()}
    if backbone == "DHRNet":
        return sd | {"incre_modules.0.0.conv1.weight": torch.zeros(32, 18, 1, 1),
                     "classifier.weight": torch.zeros(1000, 2048),
                     "classifier.bias": torch.zeros(1000)}
    return sd | {"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}


def test_apply_pretrained_matches_jax(nets, tmp_path):
    """weights_init=pretrained: the depth encoder from the backbone's
    ImageNet file and the pose encoder from resnet18.pth, merged into the
    same random weights by each package's `apply_pretrained`, give the same
    weights and statistics bit for bit, and the file's values."""
    backbone, bundle, _, params, bstats = nets
    rng = np.random.default_rng(13)
    torch.save(imagenet_file(backbone, bundle, rng), tmp_path / IMAGENET_FILES[backbone])
    pose = {k[len("encoder."):]: v for k, v in bundle.pose_encoder.state_dict().items()}
    pose["conv1.weight"] = torch.from_numpy(
        rng.standard_normal((64, 3, 7, 7)).astype(np.float32))
    torch.save(pose, tmp_path / "resnet18.pth")
    opts = kw(backbone, weights_init="pretrained", weights_dir=str(tmp_path))
    port = copy.deepcopy(bundle)
    apply_pretrained(Options(**opts), port)
    jp, jbs = japply_pretrained(JOptions(**opts), copy.deepcopy(params), copy.deepcopy(bstats))
    want = convert.bundle_state_dicts(
        {r: jp[r] for r in ("encoder", "pose_encoder")},
        jax.tree.map(np.asarray, jbs), backbone=backbone)
    for role in ("encoder", "pose_encoder"):
        got = port.role(role).state_dict()
        for k, v in want[role].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), f"{role}.{k}"
    raw = torch.load(tmp_path / IMAGENET_FILES[backbone], weights_only=True)
    raw = raw.get("model", raw)
    enc = port.encoder.state_dict()
    loaded = 0
    for k, v in raw.items():
        key = k if backbone == "LiteMono" else f"encoder.{k}"
        if key in enc:
            assert torch.equal(enc[key], v), key
            loaded += 1
    assert loaded == len(enc)


def test_jax_weight_snapshot_reproduces_disparities(nets, tmp_path):
    """A JAX `save_weights` snapshot (batch_stats as an extra) of one
    bundle's weights, read into a bundle built from another seed, gives
    that bundle's disparities bit for bit, and the JAX package's within
    3e-4."""
    backbone, bundle, jb, params, bstats = nets
    path = str(tmp_path / f"{backbone}_KITTI_MR.pkl")
    jckpt.save_weights(path, params, JOptions(**kw(backbone)), extra={"batch_stats": bstats})
    other = build_bundle(Options(**kw(backbone)), 8, "cpu", for_training=False)
    assert ckpt_lib.load_jax_weights(path, other) == []
    x = images(15)
    want = TM.single_frame_disp(bundle, nchw(x))
    got = TM.single_frame_disp(other, nchw(x))
    assert torch.equal(got, want)
    ref = np.asarray(JM.single_frame_disp(jb, params, bstats, jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(got), ref, atol=ATOL)
