"""Probes of the CUDA kernels on the card: the crossing-matrix ladder
(``crossmat_floor``, ``crossmat_variants``) and the device timer they
share (``timing``). Run as ``python -m pollen_tpu_torch.probes.<name>``."""
