"""The port's random init against the JAX package's for D-HRNet (encoder,
decoders, fusion, pose net), by the checks and tolerances of
tests/test_torch_init.py, and what that init does to D-HRNet's disparities
in both packages; a file of its own because the JAX package's D-HRNet init
takes most of a minute on the CPU (eager: its jitted init compiles for
longer), its eager forward pass a further ~20 s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mono_vifi_tpu.training import monovifi as JMM
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training.factory import build_bundle
from tests.test_torch_init import CFG, _two_threads, check_bundle, jax_init, np_tree  # noqa: F401
from tests.test_torch_parallel import torch_default_init

SATURATED = 0.9  # the least share of disparities within 1e-3 of 0 or 1


@pytest.fixture(scope="module")
def jax_dhrnet():
    """The JAX package's D-HRNet bundle and its `init_variables` (key 0)."""
    return jax_init("DHRNet", jit=False)


def test_dhrnet_bundle_init_follows_the_jax_rule(jax_dhrnet):
    check_bundle("DHRNet", jax_dhrnet)


def saturation(disp) -> float:
    """The share of disparities within 1e-3 of 0 or 1."""
    disp = np.asarray(disp)
    return float(((disp < 1e-3) | (disp > 1 - 1e-3)).mean())


def test_dhrnet_disparities_saturate_at_the_jax_rule_init(jax_dhrnet):
    """Why the parity tests compare D-HRNet on torch's default init
    (tests/test_torch_parallel.py torch_default_init): at the JAX package's
    own init (`init_variables`) more than 90% of its D-HRNet's eval-mode
    disparities lie within 1e-3 of 0 or 1 (where a sigmoid of a large input
    turns its rounding into the output's; at key 0 all of them are 1). The
    port fed that init gives the same disparities (atol 1e-5), its own draw
    by the same rule saturates as far, and torch's default init not at
    all."""
    jbundle, params, bstats = jax_dhrnet
    x = np.random.default_rng(4).random((2, 64, 96, 3), np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = np.asarray(JMM.single_frame_disp(jbundle, params, bstats, jnp.asarray(x)))

    cfg = Options(**CFG, backbone="DHRNet")
    fed = build_bundle(cfg, 3, "cpu")
    jsds = convert.bundle_state_dicts(np_tree(params), np_tree(bstats), backbone="DHRNet")
    for role in ("encoder", "depth"):
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in jsds[role].items()}
        assert fed.role(role).load_state_dict(sd, strict=False).unexpected_keys == []
    got = TM.single_frame_disp(fed, nchw).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)

    own = TM.single_frame_disp(build_bundle(cfg, 3, "cpu"), nchw)
    with torch_default_init():
        default = TM.single_frame_disp(build_bundle(cfg, 3, "cpu"), nchw)
    shares = {"JAX": saturation(ref), "port fed the JAX init": saturation(got),
              "port's own draw": saturation(own), "torch's default": saturation(default)}
    assert min(shares["JAX"], shares["port fed the JAX init"],
               shares["port's own draw"]) > SATURATED, shares
    assert shares["torch's default"] == 0.0, shares
