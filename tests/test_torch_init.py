"""The port's random init against the JAX package's, leaf by leaf, on the
CPU: the JAX package's parameters (its bundle's `init_variables`, as
`create_train_state` draws them, for ResNet18 and LiteMono at 64x96, batch
2, and `init_vfi` for IFRNet tiny and large; D-HRNet in
tests/test_torch_init_dhrnet.py) mapped into the port's keys by
`convert.bundle_state_dicts`, against the port's bundle (`build_bundle`)
and VFI state (`create_vfi_state`) built from a seed. The JAX inits are
jitted (the same values as eager, in a fifth of the time), D-HRNet's eager
(its jitted init compiles for longer than the eager one runs).

The two packages draw from different RNGs, so values are compared by
distribution. For every key: the shapes equal; an all-zero JAX leaf is all
zero in the port; a constant JAX leaf (BatchNorm and LayerNorm scales and
statistics, PReLU's 0.25, LiteMono's temperature and layer scales) is the
same constant. For a random leaf, by the rule of its layer: a conv or
linear kernel is Flax's `lecun_normal`, a normal truncated at 2 std and
rescaled to a std of sqrt(1/fan_in), so max|w| <= 2.01 sqrt(1/fan_in) /
0.8796; a `ConvTranspose4x4` kernel is uniform in +-sqrt(1/(16 cin)). A
random leaf of at least 1,000 elements also has its std within 10% of the
JAX leaf's and of the rule's (sqrt(1/fan_in), or the uniform bound over
sqrt(3)): at 1,000 draws the sample std's own spread is about 2%.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import factory as JM
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training.factory import build_bundle
from mono_vifi_tpu_torch.training.vfi import create_vfi_state

CFG = dict(height=64, width=96, batch_size=2, use_affine=True, compute_dtype="float32",
           fuse_model_type="shared_encoder", vfi_train_scale="tiny", vfi_test_scale="tiny",
           weights_init="scratch")
STD_RTOL = 0.10  # std vs the JAX leaf's and vs the rule's
MIN_STD_NUMEL = 1000  # leaves this large get the std check
NORMAL_MAX = 2.01 / 0.87962566103423978  # max|w| over sqrt(1/fan_in)


def rules(module: nn.Module) -> dict:
    """{state_dict key: (kind, fan_in)} of every randomly drawn kernel."""
    out = {}
    for name, m in module.named_modules():
        key = f"{name}.weight" if name else "weight"
        w = getattr(m, "weight", None)
        if isinstance(m, nn.ConvTranspose2d):
            out[key] = ("uniform", w.shape[0] * w[0, 0].numel())
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            out[key] = ("normal", w[0].numel())
    return out


def check_module(jsd: dict, port: nn.Module, where: str) -> int:
    """Hold `port`'s state_dict to the JAX leaves `jsd` (see the module
    docstring); -> the number of random leaves checked by std."""
    psd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    extra = set(psd) - set(jsd)
    assert all(k.endswith("num_batches_tracked") for k in extra), (where, extra)
    assert set(jsd) <= set(psd), (where, set(jsd) - set(psd))
    kinds = rules(port)
    n_std = 0
    for k, j in jsd.items():
        j, p = np.asarray(j, np.float32), psd[k].astype(np.float32)
        name = f"{where}:{k}"
        assert p.shape == j.shape, (name, p.shape, j.shape)
        if not np.any(j):
            assert not np.any(p), (name, "JAX all zero", np.abs(p).max())
            continue
        if np.all(j == j.flat[0]):
            assert np.all(p == j.flat[0]), (name, "JAX constant", j.flat[0], p.min(), p.max())
            continue
        assert k in kinds, (name, "random in JAX, but not a conv, linear or transposed kernel")
        kind, fan_in = kinds[k]
        scale = np.sqrt(1.0 / fan_in)
        if kind == "normal":
            rule_std = scale
            assert np.abs(p).max() <= NORMAL_MAX * scale, (name, np.abs(p).max() / scale)
        else:
            rule_std = scale / np.sqrt(3.0)
            assert np.abs(p).max() <= scale, (name, np.abs(p).max() / scale)
        if j.size >= MIN_STD_NUMEL:
            n_std += 1
            assert abs(p.std() / j.std() - 1) <= STD_RTOL, (name, p.std(), j.std())
            assert abs(p.std() / rule_std - 1) <= STD_RTOL, (name, p.std(), rule_std)
    return n_std


def np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_init(backbone: str, jit: bool = True) -> tuple:
    """The JAX package's training bundle for `backbone` at CFG and its
    `init_variables` from key 0: (bundle, params, batch_stats)."""
    jbundle = JM.ModelBundle(JOptions(**CFG, backbone=backbone))
    init = jax.jit(jbundle.init_variables) if jit else jbundle.init_variables
    return (jbundle, *init(jax.random.PRNGKey(0)))


def check_bundle(backbone: str, jax_variables: tuple | None = None):
    """Every trainable role of a training bundle (its frozen VFI:
    test_vfi_init_follows_the_jax_rule), against `jax_variables` (default:
    `jax_init(backbone)`)."""
    cfg = CFG | {"backbone": backbone}
    _, params, bstats = jax_variables or jax_init(backbone)
    jsds = convert.bundle_state_dicts(np_tree(params), np_tree(bstats), backbone=backbone)
    bundle = build_bundle(Options(**cfg), seed=0, device="cpu")
    assert set(jsds) == set(bundle.trainable_roles()), (set(jsds), set(bundle.trainable_roles()))
    n_std = sum(check_module(jsd, bundle.role(role), f"{backbone} {role}")
                for role, jsd in jsds.items())
    assert n_std > 10, n_std
    # as in the JAX package, the multi-frame decoder starts as the decoder's copy
    for k, v in bundle.depth.state_dict().items():
        assert torch.equal(bundle.depth_mf.state_dict()[k], v), k


@pytest.mark.parametrize("backbone", ["ResNet18", "LiteMono"])
def test_bundle_init_follows_the_jax_rule(backbone):
    check_bundle(backbone)


@pytest.mark.parametrize("scale", ["tiny", "large"])
def test_vfi_init_follows_the_jax_rule(scale):
    """IFRNet as the training bundle's frozen VFI and as `create_vfi_state`'s
    trainable one."""
    cfg = CFG | {"vfi_train_scale": scale, "vfi_scale": scale}
    jbundle = JM.ModelBundle(JOptions(**cfg))
    vfi = jax.jit(lambda key: jbundle.init_vfi(key, "train"))(jax.random.PRNGKey(1))
    jsd = convert.bundle_state_dicts({}, vfi_params=np_tree(vfi))["vfi_train"]
    bundle = build_bundle(Options(**cfg), seed=0, device="cpu")
    state = create_vfi_state(Options(**cfg), seed=0, device="cpu")
    assert check_module(jsd, bundle.vfi_train, f"IFRNet {scale} (bundle)") > 5
    assert check_module(jsd, state.module, f"IFRNet {scale} (VFI state)") > 5

