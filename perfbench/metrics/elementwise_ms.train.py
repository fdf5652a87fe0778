"""Device ms per step in elementwise kernels (PyTorch's elementwise and
vectorized kernels: activations and their backward, the losses' arithmetic,
the arithmetic of plain warps such as IFRNet's feature warps), over the
traced stretch."""


def read(run):
    tr = run.trace
    ms = tr.category_seconds().get("elementwise") if tr else None
    return ms / tr.items * 1e3 if ms else None
