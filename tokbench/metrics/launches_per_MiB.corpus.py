"""Kernel launches a MiB of input (kernels.launches)."""

from tb.readers import launches_per_mib


def read(rec):
    return launches_per_mib(rec, "corpus")
