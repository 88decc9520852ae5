"""Attention ops; kernels are built from ``ray_tpu_torch/csrc``."""
