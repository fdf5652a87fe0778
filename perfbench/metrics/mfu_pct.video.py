"""The whole frame's share of the card's f32 peak outside the tensor cores
(67 TFLOP/s, H100 SXM; TF32 is off), in %: the model FLOPs of a frame
(perfbench.counts.flops, over the plain reference) times the window's
untraced frames, over their time."""

PEAK = 67e12


def read(run):
    w = run.window
    if not run.flops_per_item or not w.timed_items:
        return None
    return 100.0 * run.flops_per_item * w.timed_items / w.timed_seconds / PEAK
