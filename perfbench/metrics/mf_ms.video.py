"""Host ms from the call of `multi_frame_disp` to its disparity on
the host, the median over the window's untraced frames."""

import statistics


def read(run):
    d = run.spans.durations("mf_call", since=run.window.t0)[:run.window.timed_items]
    return statistics.median(d) * 1e3 if d else None
