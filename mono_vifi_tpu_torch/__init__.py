"""PyTorch + CUDA port of the Mono-ViFI training system (mono_vifi_tpu).

Layout mirrors the JAX package: `config`, `ops` (geometry, sampling, image,
losses, and `ops.cuda` with the hand-written Hopper kernels), `models`,
`training` and `convert`. Sources of the kernels live in `csrc/`.
"""
