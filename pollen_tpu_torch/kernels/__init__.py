"""Hand-written CUDA kernels (``csrc/``) with their host packers and
plain PyTorch versions. Nothing here builds or launches at import."""
