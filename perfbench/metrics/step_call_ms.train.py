"""Host ms per step in the call of `train_step` (the step layer's host
time: dispatch of every kernel, and any wait inside the call), averaged over
the window's untraced steps."""


def read(run):
    d = run.spans.durations("step_call", since=run.window.t0)[:run.window.timed_items]
    return sum(d) / len(d) * 1e3 if d else None
