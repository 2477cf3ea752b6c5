"""frieda_tpu_torch: the FRIDA commitment on PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of `frieda_tpu` (the JAX/TPU package, kept as the reference). It
imports torch and numpy only, never jax or frieda_tpu. Entry point:
`frieda_tpu_torch.api.commit(data, log_blowup_factor, device)`.
"""
