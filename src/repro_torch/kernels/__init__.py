"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``),
their plain PyTorch versions, the build, and the ``ops`` dispatch."""
