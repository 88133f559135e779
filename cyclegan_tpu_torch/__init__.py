"""PyTorch/CUDA port of cyclegan_tpu for one NVIDIA H100.

The JAX package ``cyclegan_tpu`` is the reference; this package imports
neither it nor JAX. Every op that the JAX package ran as a Pallas kernel
is a hand-written CUDA kernel here (``kernels/csrc``), with a plain
PyTorch version beside it that runs on CPU tensors.
"""
