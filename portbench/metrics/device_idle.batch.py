"""device_idle.batch: 1 - device busy / traced window, torch.profiler CUDA
activity, margins not counted, % (batch entry)."""

from portbench import layers


def read(run):
    return layers.device_idle_pct(run, "batch")
