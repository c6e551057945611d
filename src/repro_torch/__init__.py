"""PyTorch/CUDA port of the JITA4DS reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
layout and imports nothing of it (nor ``jax``). Slice 1 covers the paper's
data-science loop: the 16-task workload, VDC composition, the scheduling
core, the executor, and the device operators with their hand-written CUDA
kernels (``kmeans_assign``, ``window_agg``).
"""
