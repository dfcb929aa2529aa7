"""Corpus throughput of the traced window, MB/s (host clock): corpus_MBps
as a per-layer reading, where the host's speed spreads it too widely to
judge a change by."""

from tb.readers import rate_mbps


def read(rec):
    return rate_mbps(rec, "corpus")
