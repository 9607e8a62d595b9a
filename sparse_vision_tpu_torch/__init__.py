"""PyTorch/CUDA port of sparse_vision_tpu for NVIDIA Hopper (H100).

The JAX package ``sparse_vision_tpu`` stays the reference; this package keeps its
module paths and function contracts, imports nothing from it, and runs its entry
points on CUDA unless the caller passes ``device="cpu"`` (device.resolve_device).
The fused SAE training op (ops/fused_sae.py) launches hand-written CUDA kernels
(csrc/) on CUDA tensors and runs their plain PyTorch versions on CPU tensors.
"""
