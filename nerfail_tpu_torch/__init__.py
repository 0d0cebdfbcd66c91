"""PyTorch/CUDA port of nerfail_tpu.

Mirrors the JAX package's module paths. Imports torch, numpy and scipy,
never JAX or the JAX package. Every TPU kernel on a ported path is a
hand-written CUDA kernel under `csrc/`, built at first use by
`ops/cuda/build.py`; each has a plain PyTorch version beside it that runs
on the CPU.
"""
