"""Attention kernels of the port: hand-written CUDA for Hopper (``csrc/``),
their plain PyTorch versions (``ref``) and the dispatching entry points
(``ops``)."""
