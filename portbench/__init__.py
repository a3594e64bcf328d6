"""The benchmark of the PyTorch and CUDA port (``pollen_tpu_torch``):
subset-depth queries on a resident graph, from the library call to the
answer in host memory. Run one cell with ``python -m portbench``; see
``README.md``."""
