"""Unit rows dispatched to the card a MiB of input (Counters.dispatched_rows),
in the cells judged by the card's time: each row is work of K5 and K6."""

from tb.readers import rows_per_mib


def read(rec):
    return rows_per_mib(rec, "corpus")
