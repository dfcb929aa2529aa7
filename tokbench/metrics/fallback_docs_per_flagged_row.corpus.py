"""Fallback documents a device row flagged (Counters.fallback_docs over
Counters.flagged_rows): how many documents one flagged row sends to the
fallback; None where no row was flagged."""

from tb import stages


def read(rec):
    rows = stages.counter(rec, "corpus", "flagged_rows")
    if not rows:
        return None
    return rec["counters"]["fallback_docs"] / rows
