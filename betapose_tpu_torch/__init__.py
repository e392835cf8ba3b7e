"""Betapose in PyTorch for NVIDIA GPUs.

A port of the JAX package `betapose_tpu` (which stays the reference) with the
same module layout: `core/`, `data/`, `geometry/`, `models/`, `ops/`,
`eval/`, `train/`.  Hand-written CUDA kernels live in `csrc/` and are built with
`nvcc` at first use (`ops/kernels/build.py`).  Importing the package imports
no JAX and nothing of `betapose_tpu`.
"""
