"""The whole step's share of the card's dense bf16 peak (989.4 TFLOP/s,
H100 SXM), in %: the model FLOPs of a step (perfbench.counts.flops, over
the plain reference) times the window's untraced steps, over their time."""

PEAK = 989.4e12


def read(run):
    w = run.window
    if not run.flops_per_item or not w.timed_items:
        return None
    return 100.0 * run.flops_per_item * w.timed_items / w.timed_seconds / PEAK
