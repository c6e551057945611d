"""Hand-written CUDA kernels of the port, each with a plain torch version.

Sources live in ``repro_torch/csrc``; :mod:`repro_torch.kernels._build`
compiles them with ``nvcc`` at first use and loads them with ``ctypes``.
"""
