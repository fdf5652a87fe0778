"""A frozen plain PyTorch copy of the Mono-ViFI models, ops, training step
and update that the benchmark holds the port to: the port's modules of the
same names with every hand-written kernel replaced by its plain form
(`ops/plain_kernels.py`), no process groups, no recomputation, and AdamW
written out. It computes in the configuration's precision (convolutions in
its `compute_dtype` with f32 parameters; the evaluation in f32 with TF32
off), and with `precision.operands("float8")` one precision below, the
control. It imports nothing of the port."""
