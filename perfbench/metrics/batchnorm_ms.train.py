"""Device ms per step in batch norm kernels, over the traced stretch."""


def read(run):
    tr = run.trace
    ms = tr.category_seconds().get("batch norm") if tr else None
    return ms / tr.items * 1e3 if ms else None
