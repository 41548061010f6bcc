"""PyTorch + CUDA port of the unified kernel-segregated transpose convolution.

Mirrors ``src/repro`` (the JAX package, which stays the reference) module
for module. The port imports ``torch`` only: never ``jax`` and nothing of
``repro``. Tensors are NHWC activations and HWIO kernels at every public
function, so parity tests compare like with like.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
