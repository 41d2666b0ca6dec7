"""PyTorch / CUDA port of the HexGen serving system for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (the reference it is tested
against) but imports nothing of it and never imports jax. Entry points run
on the CUDA device unless the caller passes ``device="cpu"``; on a CPU
tensor every kernel wrapper runs its plain PyTorch version instead.
"""
