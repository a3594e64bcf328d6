"""device_idle.single: 1 - device busy / traced window, torch.profiler CUDA
activity, margins not counted, % (single entry)."""

from portbench import layers


def read(run):
    return layers.device_idle_pct(run, "single")
