"""Host ms per VFI step in the port's `train_step.backward` span
(`loss.backward()`), summed over the traced stretch.

It reads the profiled stretch, where the profiler slows the host's
dispatch: two versions of the port compare under the same conditions, and
it is not an untraced time. A port that emits no such span in the VFI step
reads nothing."""

from perfbench.program_spans import ms_per_item


def read(run):
    return ms_per_item(run, "train_step.backward")
