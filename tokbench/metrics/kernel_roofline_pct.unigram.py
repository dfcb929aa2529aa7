"""The least time for the window's work (tb/roofline.py) over its kernels'
profiled device time, %, in the cells judged by the card's time."""

from tb.readers import roofline


def read(rec):
    return roofline(rec, "corpus")
