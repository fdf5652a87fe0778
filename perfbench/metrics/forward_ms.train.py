"""Host ms per step in the port's `train_step.forward` span (`zero_grad` and
the loss's forward: frozen VFI, pose, encoder, decoders, fusion, losses),
summed over the traced stretch.

It reads the profiled stretch, where the profiler slows the host's dispatch
(on an H100, traced ResNet18 steps took 239-293 ms against ~227 ms
untraced, D-HRNet 679-775 against ~464): two versions of the port compare
under the same conditions, and it is not an untraced time. A port that
emits no such span reads nothing."""

from perfbench.program_spans import ms_per_item


def read(run):
    return ms_per_item(run, "train_step.forward")
