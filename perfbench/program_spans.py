"""What the per-layer readers of the port's own spans share: host ms per
step or frame in one span of `mono_vifi_tpu_torch.tracing`, from the traced
stretch."""


def ms_per_item(run, name: str):
    """The durations of the port's span `name` in the traced stretch, summed,
    in ms, over the stretch's steps or frames; None without a trace or where
    the port emits no such span."""
    tr = run.trace
    d = [b - a for n, a, b in tr.host_spans if n == name] if tr is not None else []
    return sum(d) / tr.items / 1e3 if d else None
