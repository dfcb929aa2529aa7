"""The least time for the window's work (tb/roofline.py) over its kernels'
profiled device time, %, on the classic doc rows."""

from tb.readers import roofline


def read(rec):
    return roofline(rec, "corpus")
