"""PyTorch / CUDA port of dusty_gan_v2_tpu for NVIDIA Hopper (H100).

It mirrors the JAX package's layout (ops/, models/, geometry/, metrics/, augment/,
parallel/, convert/, training/, utils/) and imports nothing of it. Hand-written CUDA
kernels live in csrc/ and are built by kernels.py at first use. Entry points default to device="cuda" and raise
when no card is present; the CPU runs only when asked for.
"""
