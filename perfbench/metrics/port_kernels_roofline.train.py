"""The port's six hand-written kernels' share of their memory roofline,
in %: the bytes their launches in the traced stretch must move (each input
read once, each output written once, from the call shapes) over 3.35 TB/s,
divided by the device time of the kernels the launches ran."""

from perfbench.counts.kernel_bytes import bound_seconds


def read(run):
    tr = run.trace
    if tr is None or not tr.launches:
        return None
    spent = tr.category_seconds().get("port")
    bound = bound_seconds(tr.launches)
    if not spent or bound is None:
        return None
    return 100.0 * bound / spent
