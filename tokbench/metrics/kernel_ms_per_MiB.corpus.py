"""Profiled device ms of the window's kernels a MiB of input."""

from tb.readers import kernel_ms_per_mib


def read(rec):
    return kernel_ms_per_mib(rec, "corpus")
