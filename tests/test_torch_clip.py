"""The training step's global-norm clip (mono_vifi_tpu_torch.training.optim
`global_norm`, `clip_by_global_norm_`) against optax's rule written out leaf
by leaf here: g / norm * max_norm when norm >= max_norm, the leaf untouched
otherwise, no epsilon. Given the same norm the multi-tensor clip equals the
per-leaf form bit for bit (g / 1 * 1 is g); the norm, a sum over the
leaves' own norms, is within 1e-5 relative of an f64 norm. `CLIP_COUNTS`
shows one (device, dtype) group per call.

This file imports neither JAX nor tests/conftest.py's setup, so its card
cases run on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_clip.py
"""

import pytest
import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training import optim as O

SHAPES = [(64, 3, 7, 7), (1,), (64,), (128, 64, 3, 3), (1, 1, 1, 1), (10,), (3, 3)]


def per_leaf_clip(grads, max_norm, norm):
    """optax.clip_by_global_norm one leaf at a time."""
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def f64_norm(grads) -> float:
    return float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))


def leaves(scale, dtypes=(torch.float32,), device="cpu", seed=0):
    """Leaves of mixed shapes, 1-element ones among them, the last all zeros
    (a leaf the backward did not reach)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = [scale * torch.randn(s, generator=gen, device=device).to(dtypes[i % len(dtypes)])
           for i, s in enumerate(SHAPES[:-1])]
    return out + [torch.zeros(SHAPES[-1], device=device)]


@pytest.mark.parametrize("case", ["above", "below", "at", "two_dtypes"])
def test_clip_matches_per_leaf_optax_rule(case):
    dtypes = (torch.float32, torch.float64) if case == "two_dtypes" else (torch.float32,)
    grads = leaves(0.01 if case == "below" else 1.0, dtypes)
    norm = O.global_norm(grads)
    assert norm.dtype == torch.float32
    assert abs(float(norm) / f64_norm(grads) - 1) < 1e-5
    max_norm = float(norm) if case == "at" else 5.0
    before = [g.clone() for g in grads]
    expected = per_leaf_clip(grads, max_norm, norm)
    O.reset_clip_counts()
    O.clip_by_global_norm_(grads, max_norm, norm)
    for g, e in zip(grads, expected):
        assert g.dtype == e.dtype and torch.equal(g, e)
    if case == "below":
        assert all(torch.equal(g, b) for g, b in zip(grads, before))
    else:
        assert abs(f64_norm(grads) / max_norm - 1) < 1e-5
    assert O.CLIP_COUNTS == {"calls": 1, "leaves": len(SHAPES), "groups": len(dtypes)}


def test_apply_gradients_clips_every_leaf_in_one_group():
    cfg = Options(height=64, width=96, batch_size=2, use_affine=True,
                  compute_dtype="float32", fuse_model_type="shared_encoder",
                  vfi_train_scale="tiny", vfi_test_scale="tiny",
                  weights_init="scratch", device="cpu")
    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for p in state.params[1:]:  # the first leaf keeps no gradient
        p.grad = torch.randn(p.shape, generator=gen)
    O.reset_clip_counts()
    gnorm = TM.apply_gradients(state, cfg.clip_grad)
    assert float(gnorm) > cfg.clip_grad
    assert torch.equal(state.params[0].grad, torch.zeros_like(state.params[0]))
    assert O.CLIP_COUNTS == {"calls": 1, "leaves": len(state.params), "groups": 1}
    assert state.step == 1


@pytest.mark.gpu
@pytest.mark.parametrize("backbone", ["ResNet18", "DHRNet"])
def test_clip_on_the_card(backbone):
    """The leaves of a training configuration's bundle on the card: one
    group per call, the clip bit for bit the per-leaf form's, the norm
    within 1e-5 of f64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = Options(backbone=backbone, use_affine=True, fuse_model_type="shared_encoder",
                  weights_init="scratch", compute_dtype="bfloat16")
    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for p in state.params[1:]:
        p.grad = 0.05 * torch.randn(p.shape, generator=gen, device="cuda")
    grads = TM._filled_grads(state.params)
    norm = O.global_norm(grads)
    assert abs(float(norm) / f64_norm(grads) - 1) < 1e-5
    for max_norm in (float(norm) / 2, float(norm) * 2):
        expected = per_leaf_clip(grads, max_norm, norm)
        work = [g.clone() for g in grads]
        O.clip_by_global_norm_(work, max_norm, norm)
        assert all(torch.equal(w, e) for w, e in zip(work, expected))
    O.reset_clip_counts()
    TM.apply_gradients(state, cfg.clip_grad)
    torch.cuda.synchronize()
    assert O.CLIP_COUNTS == {"calls": 1, "leaves": len(state.params), "groups": 1}
    print(backbone, "leaves", len(state.params), "norm", float(norm), dict(O.CLIP_COUNTS))
