"""PyTorch/CUDA port of the serving data plane (see ``repro`` for the JAX
reference it mirrors file for file).

Entry points (``build_model``, ``LM``, ``Engine``) run on ``cuda`` unless
the caller passes ``device="cpu"``. On a CUDA tensor every attention call
goes through a hand-written Hopper kernel (``repro_torch/kernels``); on a
CPU tensor it goes through the kernel's plain PyTorch version. The package
never imports ``jax`` or anything of ``repro``.
"""
