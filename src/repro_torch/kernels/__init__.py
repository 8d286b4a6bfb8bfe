"""Hand-written Hopper kernels (CUDA C++ for sm_90a, sources in ``csrc/``)
with their plain PyTorch versions; ``ops`` dispatches by device."""
