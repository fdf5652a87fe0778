"""Host ms per frame in the port's `multi_frame_disp.flow` span (the frozen
IFRNet's flows between the two neighbours), summed over the traced stretch.

It reads the profiled stretch, where the profiler slows the host's dispatch:
two versions of the port compare under the same conditions, and it is not
an untraced time. A port that emits no such span reads nothing."""

from perfbench.program_spans import ms_per_item


def read(run):
    return ms_per_item(run, "multi_frame_disp.flow")
