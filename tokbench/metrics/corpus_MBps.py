"""Corpus throughput: input bytes of every encode_corpus_flat call of
the window over the window, MB/s (host clock)."""

from tb.readers import rate_mbps


def read(rec):
    return rate_mbps(rec, "corpus")
