"""ChronoEdit on PyTorch + CUDA (NVIDIA Hopper).

The second implementation of the ChronoEdit edit path, beside the JAX
package ``chronoedit_tpu`` (which stays the numerical reference). Plain
tensor code is PyTorch; the four kernels the JAX package wrote in Pallas
for the main edit path are hand-written CUDA C++ in ``csrc/``, built for
``sm_90a`` on first use (``kernels/build.py``).

This package never imports jax. Kernel wrappers launch their CUDA kernel
for CUDA tensors and use the plain PyTorch twin only for CPU tensors.
"""
