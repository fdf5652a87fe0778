"""Device ms per step in convolution kernels (cuDNN's, with their layout
transforms), over the traced stretch."""


def read(run):
    tr = run.trace
    ms = tr.category_seconds().get("convolution") if tr else None
    return ms / tr.items * 1e3 if ms else None
