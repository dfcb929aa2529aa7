"""Set-up: process start to the window, less the traffic's generation:
imports, the model image and tables from the checkout's cache, the
kernels' and native libraries' build or load, the engine and its device
tables, and the warm-up on the cell's own shapes (host clock), s."""

def read(rec):
    return rec.get("setup_s")
