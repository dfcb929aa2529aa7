"""Profiled device ms of the window's kernels a MiB of input, on the
classic doc rows (K1 and K2 over whole-document and chunk rows)."""

from tb.readers import kernel_ms_per_mib


def read(rec):
    return kernel_ms_per_mib(rec, "corpus")
