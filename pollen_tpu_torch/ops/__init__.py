"""Device queries of the port (PyTorch, CUDA kernels underneath)."""
