"""The port's spans (mono_vifi_tpu_torch.tracing) on the CPU, at the step
tests' config (64x96, B=2, f32, tiny VFI, affine, shared_encoder): with no
profiler running a span is one shared no-op and enters no
`record_function`, and the step and both inference entries compute exactly
what they compute under the profiler; under the profiler one step names
each step-layer span once, the loss's stages inside its forward, and the
multi-frame entry its three parts."""

import copy

import pytest
import torch

from mono_vifi_tpu_torch import tracing
from mono_vifi_tpu_torch.bench import make_batch
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import monovifi as TM

B, H, W = 2, 64, 96
CFG = Options(height=H, width=W, batch_size=B, use_affine=True, compute_dtype="float32",
              fuse_model_type="shared_encoder", vfi_train_scale="tiny",
              vfi_test_scale="tiny", weights_init="scratch", device="cpu")
PHASES = ("train_step.forward", "train_step.backward", "train_step.clip", "train_step.update")
STAGES = ("forward.vfi", "forward.pose", "forward.rotate_crop", "forward.encoder",
          "forward.depth", "forward.fusion", "forward.photometric", "forward.svdc",
          "forward.affine_losses")
ENTRY = ("single_frame_disp", "multi_frame_disp.flow", "multi_frame_disp.encoder",
         "multi_frame_disp.fusion")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """A training state from seed 0 and one batch; each use takes a copy."""
    state = TM.create_train_state(CFG, 0, steps_per_epoch=10, device="cpu")
    return state, make_batch(B, H, W, "cpu", seed=1)


def one_step_and_entries(start):
    """One train step on a copy of the state, then both inference entries
    on its weights -> (metrics, single-frame disparity, multi-frame)."""
    state, batch = copy.deepcopy(start[0]), start[1]
    step = TM.MonoViFiStep(state.bundle, device="cpu").make_train_step()
    metrics = step(state, batch, torch.Generator().manual_seed(5))
    img = [torch.rand(1, 3, H, W, generator=torch.Generator().manual_seed(i)) for i in range(3)]
    sf = TM.single_frame_disp(state.bundle, img[1])
    mf = TM.multi_frame_disp(state.bundle, *img)
    return metrics, sf, mf


@pytest.fixture(scope="module")
def profiled(start):
    """The step and the entries under torch.profiler: (outputs, spans), the
    spans as (name, start, end) of the port's names."""
    names = set(PHASES + STAGES + ENTRY) | {"train_step.grad_sync"}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = one_step_and_entries(start)
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name in names), key=lambda s: s[1])
    return out, spans


@pytest.fixture
def no_record_function(monkeypatch):
    """torch.profiler.record_function raising when called."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_span_without_profiler_is_one_shared_noop(no_record_function):
    a, b = tracing.span("train_step.forward"), tracing.span("run_epoch.step")
    assert a is b
    with a, b:
        pass


def test_paths_run_unchanged_without_profiler(start, profiled, no_record_function):
    """record_function raising: the spans never reach it, and the step and
    the entries give bit for bit what they gave under the profiler."""
    metrics, sf, mf = one_step_and_entries(start)
    (metrics_p, sf_p, mf_p), _ = profiled
    assert metrics.keys() == metrics_p.keys()
    for k in metrics:
        assert torch.equal(metrics[k], metrics_p[k]), k
    assert torch.equal(sf, sf_p) and torch.equal(mf, mf_p)


def test_step_names_each_step_span_once(profiled):
    _, spans = profiled
    names = [n for n, _, _ in spans]
    for phase in PHASES:
        assert names.count(phase) == 1, phase
    assert "train_step.grad_sync" not in names  # no process group


def test_stages_nest_in_forward_and_phases_are_in_order(profiled):
    _, spans = profiled
    at = {n: (a, b) for n, a, b in spans if n in PHASES}
    fa, fb = at["train_step.forward"]
    stages = [(n, a, b) for n, a, b in spans if n in STAGES]
    assert [n for n, _, _ in stages] == list(STAGES)
    assert all(fa <= a and b <= fb for _, a, b in stages)
    bounds = [at[p] for p in PHASES]
    assert all(prev[1] <= nxt[0] for prev, nxt in zip(bounds, bounds[1:]))


def test_entries_name_their_spans(profiled):
    _, spans = profiled
    entry = [(n, a, b) for n, a, b in spans if n in ENTRY]
    assert [n for n, _, _ in entry] == list(ENTRY)
    assert all(prev[2] <= nxt[1] for prev, nxt in zip(entry, entry[1:]))
