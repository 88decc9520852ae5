"""ray_tpu_torch — the PyTorch / CUDA port of ray_tpu's compute layer.

Mirrors the module paths of ``ray_tpu`` (``ops/``, ``models/``, ``llm/``)
and imports nothing of it and nothing of JAX. Entry points run on CUDA
unless the caller passes ``device="cpu"``; every kernel that ``ray_tpu``
wrote in Pallas for the TPU is a hand-written CUDA kernel under ``csrc/``.
"""
