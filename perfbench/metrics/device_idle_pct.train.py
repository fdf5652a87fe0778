"""Share of the time, in %, in which no operation runs on the device: one
minus the device's busy time per item in the traced stretch (the union of
its operations' intervals) over the wall time per item of the window's
untraced part, which the profiler does not slow."""


def read(run):
    tr, w = run.trace, run.window
    if tr is None or not tr.device_ops or not w.timed_items:
        return None
    return 100.0 * (1.0 - (tr.busy_seconds() / tr.items) / (w.timed_seconds / w.timed_items))
