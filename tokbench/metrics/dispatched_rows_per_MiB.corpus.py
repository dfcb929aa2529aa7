"""Unit rows dispatched to the card a MiB of input: the cache misses of
the cross-batch unit cache (Counters.dispatched_rows)."""

from tb.readers import rows_per_mib


def read(rec):
    return rows_per_mib(rec, "corpus")
