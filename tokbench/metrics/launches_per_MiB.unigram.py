"""Kernel launches a MiB of input (kernels.launches), in the cells judged
by the card's time."""

from tb.readers import launches_per_mib


def read(rec):
    return launches_per_mib(rec, "corpus")
